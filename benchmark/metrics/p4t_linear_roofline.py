"""The P4Transformer blocks' dense products' share of their roofline, in %
(``csrc/p4t_linear.cu``: ``to_qkv``, ``to_out``, ``ff1`` and ``ff2`` of
every block, forward, input gradient and weight gradient, with their splits
and reductions).

Per step, over ``tokens`` of ``depth`` blocks and the four (in, out)
products: ``3 · 2 · tokens · in · out`` operations (forward, input
gradient, weight gradient), ``3 · 2 · tokens · depth · D·(3·inner + inner +
2·mlp)`` in all; bytes, each read once and written once: the forward reads
X, W and the bias and writes Y, the input gradient reads dY and W and
writes dX, the weight gradient reads dY and X and writes dW and the bias's
gradient. Each product at the one-pass TF32 peak (the yardstick of
``pointnet_infer_roofline.eval``, so that whatever does this work reads at
most 100%, and the three passes of 3xTF32 at most 33.3%) or the memory's,
whichever bounds it; their sum over the segment's steps, over the device
time of every kernel whose name holds ``p4t_linear``."""

from benchmark import tracing
from benchmark.flops.pcaa_p4t import sizes


def products(dims):
    """(in, out, bias) of a block's dense products."""
    d, inner, mlp = dims["P4T_DIM"], dims["P4T_HEADS"] * dims["P4T_DIM_HEAD"], dims["P4T_MLP_DIM"]
    return [(d, 3 * inner, False), (inner, d, True), (d, mlp, True), (mlp, d, True)]


def step_bound(dims, batch):
    """The least seconds of a step's dense products."""
    _, tokens, _ = sizes(dims, batch)
    total = 0.0
    for in_, out, bias in products(dims):
        flops = 2 * tokens * in_ * out
        x, y, w, b = tokens * in_, tokens * out, in_ * out, out * bias
        total += tracing.bound(flops, 4 * (x + w + b + y), "tf32")   # forward
        total += tracing.bound(flops, 4 * (y + w + x), "tf32")       # input gradient
        total += tracing.bound(flops, 4 * (y + x + w + b), "tf32")   # weight gradient
    return dims["P4T_DEPTH"] * total


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "p4t_linear", step_bound(c["dims"], c["batch"])
                            * trace.work["steps"])
