"""Training a PCAA variant: ``train/pcaa.py::make_epoch_fns(...)[0]``
(``train_epoch``) over whole epochs of a device-resident split, the step's
noise (``z0``, the GP's ``alphas``) handed in through ``noise=``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.cells import _train
from benchmark.reference import model as ref
from benchmark.reference.centroids import sample_distant_points


class Cell(_train.TrainCell):
    def _build(self) -> None:
        from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
        from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
            VARIANTS,
            build_pcaa,
            make_epoch_fns,
        )

        ctx = self.ctx
        self.cfg = _train.config(ctx)
        spec = dataclasses.replace(VARIANTS[VARIATION(ctx.config["variant"])],
                                   use_disc_head=ctx.config["proj_head_on_discriminator"])
        self.mods, self.state = build_pcaa(self.cfg, spec, device=self.device)
        _train.load_weights((self.mods.g, self.mods.d), _train.weights(ctx, self.device))
        self.noise_shapes = ((self.cfg.SUP_LATENT_DIM,), (1,))
        self.train_epoch = make_epoch_fns(self.mods, self.cfg)[0]

    def _epoch(self, perm, noise):
        self.state, m = self.train_epoch(self.state, self.x, self.y, perm, noise=noise)
        return m

    def _params(self) -> Dict[str, torch.Tensor]:
        return {**dict(self.mods.g.named_parameters()), **dict(self.mods.d.named_parameters())}

    def _moments(self):
        return [(self.state.opt_g.mu, self.cfg.B1), (self.state.opt_d.mu, self.cfg.B1)]


def reference(ctx, readings: Dict, exact: bool = True) -> Dict:
    """The plain V4 step three times from the same weights, rows and noise:
    losses, the step-1 gradient norms and the change norms."""
    device = torch.device(ctx.device)
    ref.exact_f32(exact)
    xs, ys, p = _train.reference_inputs(ctx, readings, device)
    d = ctx.dims
    centroids = torch.from_numpy(sample_distant_points(
        d["SUP_LATENT_DIM"], ctx.n_classes, min_dist=10, sphere_radius=10, seed=42)).to(device)
    hp = dict(d, shape=(d["NSTEPS"], d["NMAX"], d["NFEATURES"]))
    z0, alphas = (n.to(device) for n in readings["noise"])
    p0 = {k: v.clone() for k, v in p.items()}
    opt_g, opt_d, losses = {}, {}, []
    for i in range(xs.shape[0]):
        loss, grads = ref.pcaa_v4_step(p, opt_g, opt_d, xs[i], ys[i], z0[i], alphas[i],
                                       centroids, hp)
        losses.append(loss)
        if i == 0:
            grad_norms = _train.leaf_norms(grads)
    change = _train.leaf_norms({k: p[k] - p0[k] for k in p})
    ref.exact_f32(True)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def check(ctx, readings: Dict) -> List[Tuple[str, float, float]]:
    return _train.checked(ctx, readings, lambda exact: reference(ctx, readings, exact))


compare = _train.compare
explain = _train.explain
