"""Device ms a training step of the kernels that the P4Transformer
encoder's ``p4t.embed`` spans launch (farthest-point sampling, the ball
query, the tube's forward, the position embedding and the sum), over the
``train.steps`` counter, from the pass with the program's recorder on. The
spans hold the forward: the tube's backward runs under ``train.backward``.
None where the trace holds no such span."""

from benchmark import spans


def read(trace):
    return spans.per_step_ms(trace, "p4t.embed")
