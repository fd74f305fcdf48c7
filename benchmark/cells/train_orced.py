"""Training OR-CED: ``train/orced.py::make_orced_epoch_fns(...)[0]`` over
whole epochs of a device-resident split, at the KL weight of the mix's
``epoch`` (``epoch / EPOCHS``), the reparametrization noise handed in
through ``noise=``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.cells import _train
from benchmark.reference import model as ref


def kl_mult(ctx) -> float:
    return float(np.float32(ctx.traffic["epoch"] / ctx.dims["EPOCHS"]))


class Cell(_train.TrainCell):
    def _build(self) -> None:
        from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
            build_orced,
            make_orced_epoch_fns,
        )

        self.cfg = _train.config(self.ctx)
        self.mods, self.state = build_orced(self.cfg, device=self.device)
        _train.load_weights((self.mods,), _train.weights(self.ctx, self.device))
        self.noise_shapes = ((self.cfg.SUP_LATENT_DIM,),)
        self.kl_mult = kl_mult(self.ctx)
        self.train_epoch = make_orced_epoch_fns(self.mods, self.cfg)[0]

    def _epoch(self, perm, noise):
        self.state, m = self.train_epoch(self.state, self.x, self.y, perm, self.kl_mult,
                                         noise=noise[0])
        return m

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.mods.named_parameters())

    def _moments(self):
        return [(self.state.opt.mu, self.cfg.B1)]


def reference(ctx, readings: Dict, exact: bool = True) -> Dict:
    """The plain OR-CED step three times from the same weights, rows and
    noise: losses, the step-1 gradient norms and the change norms."""
    device = torch.device(ctx.device)
    ref.exact_f32(exact)
    xs, ys, p = _train.reference_inputs(ctx, readings, device)
    d = ctx.dims
    hp = dict(d, shape=(d["NSTEPS"], d["NMAX"], d["NFEATURES"]), n_classes=ctx.n_classes)
    (eps,) = (n.to(device) for n in readings["noise"])
    p0 = {k: v.clone() for k, v in p.items()}
    opt, losses = {}, []
    for i in range(xs.shape[0]):
        loss, grads = ref.orced_step(p, opt, xs[i], ys[i], eps[i], kl_mult(ctx), hp)
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
