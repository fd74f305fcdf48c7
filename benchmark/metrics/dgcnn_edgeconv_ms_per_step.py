"""Device ms a training step of the kernels that the DGCNN encoder's
``dgcnn.edgeconv`` spans launch (each EdgeConv layer's graph, per-point
products and edge pass, forward), over the ``train.steps`` counter, from the
pass with the program's recorder on. The layers' backward runs under
``train.backward`` and is not counted here. None where the trace holds no
such span."""

from benchmark import spans


def read(trace):
    return spans.per_step_ms(trace, "dgcnn.edgeconv")
