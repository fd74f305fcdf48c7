"""The edge pass kernels' share of their roofline, in % (``csrc/
dgcnn_edge.cu``: the forward's extremum, statistics and output, the
backward's LeakyReLU gradient, sums, reverse graph and ``dA``/``dB``).

The least work of an edge pass, whatever implements it: per step and
EdgeConv layer of ``O`` channels, over ``P = B·T·N`` points and ``E = P·k``
edges (``k = min(k, N)``), the forward reads ``A`` and ``B`` (4 bytes a
point and channel each) and the graph (8 bytes an edge) once and writes the
output once, ``4·P·O·3 + 8·E`` bytes, with about 5 operations an edge and
channel (the sum ``A_i + B_j``, the extremum, the statistics); the backward
reads the output's gradient, ``A``, ``B`` and the graph and writes ``dA``
and ``dB``, ``4·P·O·5 + 8·E`` bytes, with at least 2 an edge and channel
(the sums over each point's out-edges and in-edges). Each at the f32 peak
or the memory's, whichever bounds it (the bytes, at the cell's widths); the
per-point products are cuBLAS's (``gemm_ms_per_step``) and not counted. The
sum over the layers and the segment's steps, over the device time of the
kernels."""

from benchmark import tracing
from benchmark.flops.pcaa_dgcnn import layer_widths, rows


def step_bounds(dims, batch):
    """The least seconds of one step's forward and backward edge passes."""
    p = rows(dims, batch)
    e = p * min(dims["DGCNN_K"], dims["NMAX"])
    fwd = sum(tracing.bound(5 * e * o, 4 * p * o * 3 + 8 * e, "f32")
              for _, o in layer_widths(dims))
    bwd = sum(tracing.bound(2 * e * o, 4 * p * o * 5 + 8 * e, "f32")
              for _, o in layer_widths(dims))
    return fwd, bwd


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "dgcnn_edge", sum(step_bounds(c["dims"], c["batch"]))
                            * trace.work["steps"])
