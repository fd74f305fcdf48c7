"""Device ms a training step of the kernels that the P4Transformer
encoder's ``p4t.transformer`` spans launch (the blocks' LayerNorms, cuBLAS
products, attention and GELUs, forward), over the ``train.steps`` counter,
from the pass with the program's recorder on. The blocks' backward runs
under ``train.backward`` and is not counted here. None where the trace
holds no such span."""

from benchmark import spans


def read(trace):
    return spans.per_step_ms(trace, "p4t.transformer")
