"""Training PCAA V4 with a P4Transformer encoder: ``train/pcaa.py::
build_pcaa(..., encoder=P4TSpec(...))`` and ``make_epoch_fns(...)[0]``
(``train_epoch``) over whole epochs of a device-resident split, the step's
noise handed in, as ``train_pcaa.py`` drives V4. The encoder's sizes are the
configuration's ``P4T_*`` keys; the program's ``Config`` takes the others.
The comparison is ``_train``'s, against ``reference/pcaa_v4_p4t.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

# the program's P4Transformer encoder: a checkout without it fails here, at once
from opensetgaitrecognition_pcaa_tpu_torch.models.p4t import P4TSpec

from benchmark.cells import _train, train_pcaa
from benchmark.reference import model as v4
from benchmark.reference import pcaa_v4_p4t as ref
from benchmark.reference.centroids import sample_distant_points

PREFIX = "P4T_"


def spec(ctx) -> P4TSpec:
    s = ref.spec(ctx.dims)
    return P4TSpec(**dict(s, temporal_padding=tuple(s["temporal_padding"])))


def config(ctx):
    """The program's ``Config`` from the configuration's keys other than
    the encoder's."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config

    kw = {k: v for k, v in ctx.dims.items() if not k.startswith(PREFIX)}
    for key in ("DTC_FILTERS", "TRAIN_CLASSES"):
        kw[key] = tuple(kw[key])
    return Config(BATCH_SIZE=ctx.traffic["batch"], SEED=ctx.seed % (1 << 31), **kw)


class Cell(train_pcaa.Cell):
    def _build(self) -> None:
        from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
        from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
            VARIANTS,
            build_pcaa,
            make_epoch_fns,
        )

        ctx = self.ctx
        self.cfg = config(ctx)
        variant = dataclasses.replace(VARIANTS[VARIATION(ctx.config["variant"])],
                                      use_disc_head=ctx.config["proj_head_on_discriminator"])
        self.mods, self.state = build_pcaa(self.cfg, variant, device=self.device,
                                           encoder=spec(ctx))
        _train.load_weights((self.mods.g, self.mods.d), _train.weights(ctx, self.device))
        self.noise_shapes = ((self.cfg.SUP_LATENT_DIM,), (1,))
        self.train_epoch = make_epoch_fns(self.mods, self.cfg)[0]

    def counted(self) -> Dict[str, int]:
        from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_group import (
            ball_query,
            furthest_point_sample,
        )
        from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_tube import tube_embed

        return {"adam": super().counted()["adam"],
                "p4t_group": furthest_point_sample.launches + ball_query.launches,
                "p4t_tube": tube_embed.launches}


def reference(ctx, readings: Dict, exact: bool = True) -> Dict:
    """The plain V4 + P4Transformer step three times from the same weights,
    rows and noise: losses, the step-1 gradient norms and the change norms."""
    device = torch.device(ctx.device)
    v4.exact_f32(exact)
    xs, ys, p = _train.reference_inputs(ctx, readings, device)
    d = ctx.dims
    centroids = torch.from_numpy(sample_distant_points(
        d["SUP_LATENT_DIM"], ctx.n_classes, min_dist=10, sphere_radius=10, seed=42)).to(device)
    hp = dict(d, shape=(d["NSTEPS"], d["NMAX"], d["NFEATURES"]))
    z0, alphas = (n.to(device) for n in readings["noise"])
    p0 = {k: v.clone() for k, v in p.items()}
    opt_g, opt_d, losses = {}, {}, []
    for i in range(xs.shape[0]):
        loss, grads = ref.pcaa_v4_p4t_step(p, opt_g, opt_d, xs[i], ys[i], z0[i], alphas[i],
                                           centroids, hp)
        losses.append(loss)
        if i == 0:
            grad_norms = _train.leaf_norms(grads)
        del grads
    change = _train.leaf_norms({k: p[k] - p0[k] for k in p})
    v4.exact_f32(True)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def check(ctx, readings: Dict) -> List[Tuple[str, float, float]]:
    return _train.checked(ctx, readings, lambda exact: reference(ctx, readings, exact))


compare = _train.compare
explain = _train.explain
