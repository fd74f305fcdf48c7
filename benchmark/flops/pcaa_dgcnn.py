"""The FLOPs of a training step of PCAA V4 with a DGCNN encoder, counted in
the program's per-point form: each EdgeConv layer's conv as the per-point
products ``[A | B] = x·[W_b − W_a ; W_a]ᵀ`` (``2·rows·C·2·O`` forward, layer
1's input gradient excepted: the crop takes none), ``conv5`` (512 → 1024 a
point), the TCN from 2048 channels, then V4's heads, decoder head and
decoder, critic and DPH, counted as ``pcaa.py`` counts them. The published
edge form's convs (``2·edges·2·C·O``, 20 times the products at k 20) are
not credited: the split removes that work. The graph's distances, the edge
passes and the norms are not counted (no matrix products).
"""

from benchmark.flops import decoder_widths, dense_flops


def rows(dims, batch):
    """Points a step: every frame's ``NMAX``."""
    return batch * dims["NSTEPS"] * dims["NMAX"]


def layer_widths(dims):
    """Each EdgeConv layer's (input, output) channels."""
    w = dims["DGCNN_WIDTHS"]
    return list(zip([dims["NFEATURES"]] + list(w[:-1]), w))


def encoder_flops(dims, batch):
    """The products, ``conv5`` and the TCN, forward and backward."""
    r = rows(dims, batch)
    flops = dense_flops(r, [(c, 2 * o) for c, o in layer_widths(dims)[:1]],
                        first_input_grad=False)
    flops += dense_flops(r, [(c, 2 * o) for c, o in layer_widths(dims)[1:]])
    flops += dense_flops(r, [(sum(dims["DGCNN_WIDTHS"]), dims["DGCNN_EMB_DIMS"])])
    f = dims["DTC_FILTERS"]
    tcn = list(zip([2 * dims["DGCNN_EMB_DIMS"]] + list(f[:-1]), f))
    return flops + dense_flops(batch * dims["NSTEPS"], [(3 * a, b) for a, b in tcn])


def step_flops(dims, batch, n_classes):
    latent = dims["SUP_LATENT_DIM"]
    flops = encoder_flops(dims, batch)
    flops += dense_flops(batch, [(dims["DTC_FILTERS"][-1], latent), (latent, latent // 2),
                                 (latent // 2, n_classes)])
    flops += dense_flops(batch, [(latent, 2 * latent)] + decoder_widths(dims, 2 * latent))
    critic = 2 * batch * ((latent + n_classes) * 64 + 64 * 32 + 32)
    flops += 4 * 3 * critic + 2 * critic
    flops += 3 * 2 * batch * latent * latent
    return flops
