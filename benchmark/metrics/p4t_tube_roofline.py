"""The tube kernels' share of their roofline, in % (``csrc/p4t_tube.cu``:
the forward, and the backward's weight gradient with its reduction).

Per step, over ``rows = tokens·KT·K`` samples of ``D`` channels: the
forward does ``2·rows·5·D`` operations and moves the crops ``B·T·N·4``
floats, the anchor and ball indices (8 bytes each) and the weights ``5·D``
floats in, the maxima (4 bytes) and the one-byte argmax of ``tokens·D``
out; the backward's weight gradient does ``2·tokens·5·D`` (each channel's
maximal sample alone) and moves the crops, the indices, the gradient and
the argmax in and the ``5·D`` gradient out. Each at the f32 (non-tensor)
peak or the memory's, whichever bounds it; their sum over the segment's
steps, over the device time of the kernels."""

from benchmark import tracing
from benchmark.flops.pcaa_p4t import sizes


def step_bounds(dims, batch):
    """The least seconds of the forward and of the backward of one step."""
    _, tokens, samples = sizes(dims, batch)
    d, rows = dims["P4T_DIM"], tokens * samples
    shared = 4 * batch * dims["NSTEPS"] * dims["NMAX"] * 4 + 8 * (tokens + rows) + 4 * 5 * d
    fwd = tracing.bound(2 * rows * 5 * d, shared + 5 * tokens * d, "f32")
    bwd = tracing.bound(2 * tokens * 5 * d, shared + 5 * tokens * d, "f32")
    return fwd, bwd


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "p4t_tube", sum(step_bounds(c["dims"], c["batch"]))
                            * trace.work["steps"])
