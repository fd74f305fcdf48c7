"""PCAA's FLOPs: a training step of V4 with the discriminator projection
head, and one crop through the eval encoder."""

from benchmark.flops import backbone_step_flops, decoder_widths, dense_flops


def step_flops(dims, batch, n_classes):
    """The backbone, the heads, the decoder head and decoder, the critic
    (three forwards in its step, one in the generator's, each with its
    backward, and the gradient penalty's input gradient and its double
    backward, counted once as computed) and the DPH."""
    latent = dims["SUP_LATENT_DIM"]
    f = dims["DTC_FILTERS"][-1]
    flops = backbone_step_flops(dims, batch)
    flops += dense_flops(batch, [(f, latent), (latent, latent // 2), (latent // 2, n_classes)])
    flops += dense_flops(batch, [(latent, 2 * latent)] + decoder_widths(dims, 2 * latent))
    critic = 2 * batch * ((latent + n_classes) * 64 + 64 * 32 + 32)
    # D step: real, fake, interpolates forward and backward; the GP's input
    # gradient and its double backward; G step: one forward and backward
    flops += 4 * 3 * critic + 2 * critic
    flops += 3 * 2 * batch * latent * latent  # the DPH: two forwards and one backward
    return flops


def crop_flops(dims, n_classes):
    """The eval forward's matrix products of one crop: the PointNet over its
    real points, the TCN, the heads."""
    t, n, d = dims["NSTEPS"], dims["NMAX"], dims["POINTNET_OUT_DIM"]
    widths = (d // 2, d // 2, d, d)
    pointnet = sum(a * b for a, b in zip((dims["NFEATURES"],) + widths[:-1], widths))
    f = dims["DTC_FILTERS"]
    tcn = sum(3 * a * b for a, b in zip((d,) + tuple(f[:-1]), f))
    latent = dims["SUP_LATENT_DIM"]
    heads = f[-1] * latent + latent * (latent // 2) + (latent // 2) * n_classes
    return 2 * (t * n * pointnet + t * tcn + heads)
