"""The training step's model FLOPs per second over the chip's peak, in %.

Model FLOPs are the step's matrix products at the configuration's shapes,
forward and backward, as the model needs them (no recomputation), counted
by the cell's family in ``benchmark/flops/<family>.py``. Distances such as
Chamfer's, normalisation and the elementwise work are not counted. The
peak is the card's dense TF32 rate, the tensor-core peak for f32 inputs,
so that no implementation of f32 training can read above 100%.
"""

from benchmark import flops as family_flops
from benchmark import tracing


def step_flops(dims, batch, family, n_classes):
    """Model FLOPs of one training step of ``family``."""
    return family_flops.family(family).step_flops(dims, batch, n_classes)


def read(trace):
    c = trace.cell
    flops = step_flops(c["dims"], c["batch"], c["family"], c["n_classes"]) * trace.work["steps"]
    return 100.0 * flops / trace.window_s / tracing.PEAK_FLOPS["tf32"]
