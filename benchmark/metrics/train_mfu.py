"""The training step's model FLOPs per second over the chip's peak, in %.

Model FLOPs are the step's matrix products at the configuration's shapes,
forward and backward, as the model needs them (no recomputation): each
product of ``(m, k) @ (k, n)`` is ``2mkn`` forward, the same again for the
weight gradient, and the same again for the input gradient where the input
needs one. Counted: the PointNet (its first layer's input gradient
excepted), the TCN, the heads, the decoder (and PCAA's decoder head), the
critic (three forwards in its step, one in the generator's, each with its
backward, and the gradient penalty's input gradient and its double
backward, counted once as computed) and OR-CED's mean learner. Chamfer's
distances, BatchNorm and the elementwise work are not counted. The peak is
the card's dense TF32 rate, the tensor-core peak for f32 inputs, so that
no implementation of f32 training can read above 100%.
"""

from benchmark import tracing


def pointnet_widths(dims):
    d = dims["POINTNET_OUT_DIM"]
    widths = (d // 2, d // 2, d, d)
    return list(zip((dims["NFEATURES"],) + widths[:-1], widths))


def tcn_widths(dims):
    f = dims["DTC_FILTERS"]
    return list(zip((dims["POINTNET_OUT_DIM"],) + tuple(f[:-1]), f))


def decoder_widths(dims, n_in):
    s = dims["NSTEPS"] * dims["NMAX"] * dims["NFEATURES"]
    w = (s // 16, s // 8, s // 4, s // 2, s)
    return list(zip((n_in,) + w[:-1], w))


def dense_flops(rows, layers, first_input_grad=True):
    """Forward, weight gradient and input gradient of a stack of dense
    layers over ``rows`` rows."""
    fwd = [2 * rows * a * b for a, b in layers]
    return 3 * sum(fwd) - (0 if first_input_grad else fwd[0])


def step_flops(dims, batch, family, n_classes):
    """Model FLOPs of one training step of ``family`` ("pcaa": V4 with the
    discriminator projection head; "orced")."""
    t, n, latent = dims["NSTEPS"], dims["NMAX"], dims["SUP_LATENT_DIM"]
    flops = dense_flops(batch * t * n, pointnet_widths(dims), first_input_grad=False)
    flops += dense_flops(batch * t, [(3 * a, b) for a, b in tcn_widths(dims)])
    f = dims["DTC_FILTERS"][-1]
    if family == "pcaa":
        flops += dense_flops(batch, [(f, latent), (latent, latent // 2), (latent // 2, n_classes)])
        flops += dense_flops(batch, [(latent, 2 * latent)] + decoder_widths(dims, 2 * latent))
        critic = 2 * batch * ((latent + n_classes) * 64 + 64 * 32 + 32)
        # D step: real, fake, interpolates forward and backward; the GP's input
        # gradient and its double backward; G step: one forward and backward
        flops += 4 * 3 * critic + 2 * critic
        flops += 3 * 2 * batch * latent * latent  # the DPH: two forwards and one backward
    else:
        flops += dense_flops(batch, [(f, latent), (f, latent), (latent, n_classes)])
        flops += dense_flops(batch, decoder_widths(dims, latent))
        flops += dense_flops(batch, [(n_classes, 16), (16, 32), (32, 64), (64, latent)],
                             first_input_grad=False)
    return flops


def read(trace):
    c = trace.cell
    flops = step_flops(c["dims"], c["batch"], c["family"], c["n_classes"]) * trace.work["steps"]
    return 100.0 * flops / trace.window_s / tracing.PEAK_FLOPS["tf32"]
