"""The point-grouping kernels' share of their roofline, in %
(``csrc/p4t_group.cu``: farthest-point sampling and the ball query).

Per step: farthest-point sampling of ``F = B·L`` anchor frames of ``N``
points takes ``m − 1`` rounds of 9 operations a point (three differences,
three products, two sums, a minimum) and moves the frames' ``N·3`` floats
in and ``m`` indices (8 bytes) out; the ball query reads each crop's
positions ``B·T·N·3`` floats, the anchors' indices and writes ``B·L·M·KT·K``
indices. Its operations depend on where each scan stops and are not
counted: a scan of every point, their upper bound, stays below the bytes'
time at the published sizes. The least time at the f32 peak or the
memory's, over the device time of the kernels: they are bound by latency
(sequential rounds, short scans), so the share is small."""

from benchmark import tracing
from benchmark.flops.pcaa_p4t import sizes


def step_bound(dims, batch):
    _, tokens, _ = sizes(dims, batch)
    n, m = dims["NMAX"], dims["NMAX"] // dims["P4T_SPATIAL_STRIDE"]
    frames = tokens // m
    fps = tracing.bound(frames * (m - 1) * n * 9, frames * (4 * n * 3 + 8 * m), "f32")
    balls = tokens * dims["P4T_TEMPORAL_KERNEL"] * dims["P4T_NSAMPLES"]
    crops = batch * dims["NSTEPS"] * n * 3
    return fps + tracing.bound(0, 4 * crops + 8 * tokens + 8 * balls, "f32")


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "p4t_group", step_bound(c["dims"], c["batch"])
                            * trace.work["steps"])
