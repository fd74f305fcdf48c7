"""The FLOPs of a training step of PCAA V4 with a P4Transformer encoder.

Per token and layer, the dense products ``2·D·(3·inner + inner + 2·mlp)``
(QKV, the output map and the two MLP maps; 16.78 MFLOP at the published
widths) and attention's ``2·2·n·inner`` (q·kᵀ and the weights times v over
the crop's n tokens; 4.61 MFLOP at n = 1,125), each three times for forward,
weight gradient and input gradient (attention's two products each have two
backward products). The tube: ``2·rows·5·D`` forward over its rows of
samples (tokens × KT·K), and the weight gradient, which takes only each
channel's maximal sample: ``2·tokens·5·D``. The position embedding
``2·tokens·4·D`` forward and as much for its weight gradient (no input
gradient reaches the crop). Then V4's heads (from D), decoder head and
decoder, critic and DPH, counted as ``pcaa.py`` counts them.
"""

from benchmark.flops import decoder_widths, dense_flops


def sizes(dims, batch):
    """(tokens a crop, tokens a step, samples a token) of the configuration."""
    t, n = dims["NSTEPS"], dims["NMAX"]
    kt, st = dims["P4T_TEMPORAL_KERNEL"], dims["P4T_TEMPORAL_STRIDE"]
    frames = (t + sum(dims["P4T_TEMPORAL_PADDING"]) - kt) // st + 1
    per_crop = frames * (n // dims["P4T_SPATIAL_STRIDE"])
    return per_crop, batch * per_crop, kt * dims["P4T_NSAMPLES"]


def transformer_flops(dims, batch):
    per_crop, tokens, _ = sizes(dims, batch)
    d, inner, mlp = dims["P4T_DIM"], dims["P4T_HEADS"] * dims["P4T_DIM_HEAD"], dims["P4T_MLP_DIM"]
    dense = 2 * d * (3 * inner + inner + 2 * mlp)
    attention = 2 * 2 * per_crop * inner
    return 3 * dims["P4T_DEPTH"] * tokens * (dense + attention)


def embed_flops(dims, batch):
    _, tokens, samples = sizes(dims, batch)
    d = dims["P4T_DIM"]
    tube = 2 * tokens * samples * 5 * d + 2 * tokens * 5 * d
    return tube + 2 * (2 * tokens * 4 * d)


def step_flops(dims, batch, n_classes):
    latent = dims["SUP_LATENT_DIM"]
    flops = transformer_flops(dims, batch) + embed_flops(dims, batch)
    flops += dense_flops(batch, [(dims["P4T_DIM"], latent), (latent, latent // 2),
                                 (latent // 2, n_classes)])
    flops += dense_flops(batch, [(latent, 2 * latent)] + decoder_widths(dims, 2 * latent))
    critic = 2 * batch * ((latent + n_classes) * 64 + 64 * 32 + 32)
    flops += 4 * 3 * critic + 2 * critic
    flops += 3 * 2 * batch * latent * latent
    return flops
