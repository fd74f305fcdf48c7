"""The eval PointNet kernel's share of its roofline, in %
(``csrc/pointnet_infer.cu``: the folded 4-layer stack and the mean over
each frame's points, one launch a chunk). Per launch of ``b`` crops,
``R = b·T·N`` real points: ``2R·Σ k·n`` operations; bytes: the crops
``R·C``, the folded weights and biases ``Σ (k·n + n)`` and the output
``b·T·D`` floats. The least time at the TF32 peak and the memory's,
summed over the segment's chunks, over the kernel's device time."""

from benchmark import tracing


def launch_bound(dims, crops):
    t, n, d, c = dims["NSTEPS"], dims["NMAX"], dims["POINTNET_OUT_DIM"], dims["NFEATURES"]
    widths = (d // 2, d // 2, d, d)
    layers = list(zip((c,) + widths[:-1], widths))
    rows = crops * t * n
    flops = 2 * rows * sum(a * b for a, b in layers)
    floats = rows * c + sum(a * b + b for a, b in layers) + crops * t * d
    return tracing.bound(flops, 4 * floats, "tf32")


def read(trace):
    c = trace.cell
    full, rest = divmod(trace.work["crops"], c["batch"])
    total = full * launch_bound(c["dims"], c["batch"]) + (launch_bound(c["dims"], rest) if rest else 0)
    return tracing.roofline(trace, "pointnet_infer", total)
