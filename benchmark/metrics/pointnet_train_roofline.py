"""The train-mode PointNet kernels' share of their roofline, in %
(``csrc/pointnet_train.cu``: per layer the f32 layer kernel and its
statistics pass, then the pool).

Per step, at f32 inputs: a layer over ``R = B·T·N`` rows from ``k`` to
``n`` channels does ``2Rkn`` operations and moves its input ``R·k``, its
weight ``k·n``, bias and the previous BatchNorm's affine ``n + 2k``, its
output ``R·n`` and its statistics ``2n`` floats; the pool reads ``R·D``
and the affine ``2D`` and writes ``B·T·D`` floats. Each launch's least time
is the larger of its operations at the TF32 peak and its bytes at the
memory's; their sum over the segment's steps, over the device time of
these kernels.
"""

from benchmark import tracing


def layer_bounds(dims, batch):
    """The least seconds of each launch of one step: 4 layers, the pool."""
    d = dims["POINTNET_OUT_DIM"]
    widths = (d // 2, d // 2, d, d)
    rows = batch * dims["NSTEPS"] * dims["NMAX"]
    out = []
    for k, n in zip((dims["NFEATURES"],) + widths[:-1], widths):
        floats = rows * k + k * n + n + 2 * k + rows * n + 2 * n
        out.append(tracing.bound(2 * rows * k * n, 4 * floats, "tf32"))
    out.append(tracing.bound(0, 4 * (rows * d + 2 * d + batch * dims["NSTEPS"] * d), "tf32"))
    return out


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "pointnet_train",
                            sum(layer_bounds(c["dims"], c["batch"])) * trace.work["steps"])
