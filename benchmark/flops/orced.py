"""OR-CED's FLOPs: a training step."""

from benchmark.flops import backbone_step_flops, decoder_widths, dense_flops


def step_flops(dims, batch, n_classes):
    """The backbone, the heads (mean, log-variance, classifier), the
    decoder and the mean learner (its first layer's input gradient
    excepted)."""
    latent = dims["SUP_LATENT_DIM"]
    f = dims["DTC_FILTERS"][-1]
    flops = backbone_step_flops(dims, batch)
    flops += dense_flops(batch, [(f, latent), (f, latent), (latent, n_classes)])
    flops += dense_flops(batch, decoder_widths(dims, latent))
    flops += dense_flops(batch, [(n_classes, 16), (16, 32), (32, 64), (64, latent)],
                         first_input_grad=False)
    return flops
