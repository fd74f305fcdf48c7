"""The P4Transformer blocks' attention's share of its roofline, in %
(``softmax(q·kᵀ/√dh)·v`` of every block, forward and backward).

Per step, over the cell's crops of ``n`` tokens, ``heads`` heads of
``dh`` and ``depth`` blocks: the forward's two products, ``4·n²·dh``
operations a head, and the backward's four, ``8·n²·dh``, with no
recomputation counted, so that whatever implements attention reads the
same work (``flops/pcaa_p4t.py`` counts it so). Bytes, each read once and
written once: the forward reads Q, K and V and writes O and the
log-sum-exp of each query row; the backward reads Q, K, V, O, dO and the
log-sum-exp and writes dQ, dK and dV. Each pass at the one-pass TF32 peak
(the yardstick of ``p4t_linear_roofline``, so that the three passes of
3xTF32 read at most 33.3%) or the memory's, whichever bounds it; their sum
over the segment's steps, over the device time of every kernel whose name
holds ``p4t_attention``."""

from benchmark import tracing
from benchmark.flops.pcaa_p4t import sizes


def step_bound(dims, batch):
    """The least seconds of a step's attention."""
    n, tokens, _ = sizes(dims, batch)
    heads, dh = dims["P4T_HEADS"], dims["P4T_DIM_HEAD"]
    products = batch * heads * 2 * n * n * dh    # one product over every head of the step
    values, rows = tokens * heads * dh, tokens * heads  # a (tokens, heads·dh) operand; lse
    forward = tracing.bound(2 * products, 4 * (4 * values + rows), "tf32")
    backward = tracing.bound(4 * products, 4 * (8 * values + rows), "tf32")
    return dims["P4T_DEPTH"] * (forward + backward)


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "p4t_attention", step_bound(c["dims"], c["batch"])
                            * trace.work["steps"])
