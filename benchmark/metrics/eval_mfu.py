"""The eval encoder's model FLOPs per second over the chip's peak, in %:
the forward's matrix products per crop (no padding, no elementwise work;
``crop_flops`` of the cell's family in ``benchmark/flops/<family>.py``)
times the crops the traced segment encoded, over its seconds and the dense
TF32 peak, the tensor-core peak for f32 inputs."""

from benchmark import flops as family_flops
from benchmark import tracing


def crop_flops(dims, n_classes, family="pcaa"):
    """Model FLOPs of one crop's eval forward (``family`` defaults to the
    family whose count ``benchmark/tests/test_bench_flops.py`` checks by hand;
    ``read`` always names the cell's)."""
    return family_flops.family(family).crop_flops(dims, n_classes)


def read(trace):
    c = trace.cell
    flops = crop_flops(c["dims"], c["n_classes"], c["family"]) * trace.work["crops"]
    return 100.0 * flops / trace.window_s / tracing.PEAK_FLOPS["tf32"]
