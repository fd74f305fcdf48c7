"""The eval encoder's model FLOPs per second over the chip's peak, in %:
the forward's matrix products per crop (the PointNet over its real points,
the TCN, the heads; no padding, no elementwise work) times the crops the
traced segment encoded, over its seconds and the dense TF32 peak, the
tensor-core peak for f32 inputs."""

from benchmark import tracing


def crop_flops(dims, n_classes):
    t, n, d = dims["NSTEPS"], dims["NMAX"], dims["POINTNET_OUT_DIM"]
    widths = (d // 2, d // 2, d, d)
    pointnet = sum(a * b for a, b in zip((dims["NFEATURES"],) + widths[:-1], widths))
    f = dims["DTC_FILTERS"]
    tcn = sum(3 * a * b for a, b in zip((d,) + tuple(f[:-1]), f))
    latent = dims["SUP_LATENT_DIM"]
    heads = f[-1] * latent + latent * (latent // 2) + (latent // 2) * n_classes
    return 2 * (t * n * pointnet + t * tcn + heads)


def read(trace):
    c = trace.cell
    flops = crop_flops(c["dims"], c["n_classes"]) * trace.work["crops"]
    return 100.0 * flops / trace.window_s / tracing.PEAK_FLOPS["tf32"]
