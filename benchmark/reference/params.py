"""The parameters of each model, by name and shape, and their seeded values.
A model that ``MODELS`` does not hold has a file of its own beside this one,
``benchmark/reference/<model>.py``, with ``leaves(dims, n_classes)``.

The names are the keys under which the program's modules hold the same
tensors, so the benchmark can hand one set of weights to both sides.
Dense kernels are ``(out, in)``, conv kernels ``(out, in, 3)``.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List, Tuple

import torch

# (name, shape, (low, high)): each value drawn uniformly from [low, high)
Leaf = Tuple[str, Tuple[int, ...], Tuple[float, float]]


def _dense(name: str, n_in: int, n_out: int) -> List[Leaf]:
    b = 1.0 / n_in ** 0.5
    return [(name + ".weight", (n_out, n_in), (-b, b)), (name + ".bias", (n_out,), (-b, b))]


def _norm(name: str, width: int) -> List[Leaf]:
    return [(name + ".scale", (width,), (0.9, 1.1)), (name + ".bias", (width,), (-0.1, 0.1))]


def _norm_stats(name: str, width: int) -> List[Leaf]:
    return [(name + ".mean", (width,), (-0.1, 0.1)), (name + ".var", (width,), (0.5, 1.5))]


def backbone(prefix: str, dims: Dict, stats: bool = False) -> List[Leaf]:
    d, c, filters = dims["POINTNET_OUT_DIM"], dims["NFEATURES"], dims["DTC_FILTERS"]
    widths = (d // 2, d // 2, d, d)
    leaves: List[Leaf] = []
    for i, (n_in, n_out) in enumerate(zip((c,) + widths[:-1], widths)):
        leaves += _dense(f"{prefix}.pointnet.dense.{i}", n_in, n_out)
        leaves += _norm(f"{prefix}.pointnet.norm.{i}", n_out)
        if stats:
            leaves += _norm_stats(f"{prefix}.pointnet.norm.{i}", n_out)
    for i, (n_in, n_out) in enumerate(zip((d,) + tuple(filters[:-1]), filters)):
        b = 1.0 / (3 * n_in) ** 0.5
        name = f"{prefix}.tcn.layers.{i}"
        leaves += [(name + ".conv.weight", (n_out, n_in, 3), (-b, b)),
                   (name + ".conv.bias", (n_out,), (-b, b))]
        leaves += _norm(name + ".norm", n_out)
        if stats:
            leaves += _norm_stats(name + ".norm", n_out)
    return leaves


def decoder_widths(dims: Dict) -> Tuple[int, ...]:
    s = dims["NSTEPS"] * dims["NMAX"] * dims["NFEATURES"]
    return (s // 16, s // 8, s // 4, s // 2, s)


def _decoder(prefix: str, n_in: int, dims: Dict) -> List[Leaf]:
    widths = decoder_widths(dims)
    leaves: List[Leaf] = []
    for i, (a, b) in enumerate(zip((n_in,) + widths[:-1], widths)):
        leaves += _dense(f"{prefix}.dense.{i}", a, b)
    return leaves


def pcaa_encoder(dims: Dict, n_classes: int, stats: bool = False) -> List[Leaf]:
    latent = dims["SUP_LATENT_DIM"]
    return (backbone("encoder.backbone", dims, stats)
            + _dense("encoder.MLP_sup1", dims["DTC_FILTERS"][-1], latent)
            + _dense("encoder.MLP_head", latent, latent // 2)
            + _dense("encoder.MLP_sup2", latent // 2, n_classes))


def pcaa_v4(dims: Dict, n_classes: int) -> List[Leaf]:
    """V4 with the discriminator projection head: the generator side
    (encoder, decoder head, decoder) and the critic side (critic, DPH)."""
    latent = dims["SUP_LATENT_DIM"]
    return (pcaa_encoder(dims, n_classes)
            + _dense("dec_head.dense", latent, 2 * latent)
            + _decoder("decoder", 2 * latent, dims)
            + _dense("discriminator.dense.0", latent + n_classes, 64)
            + _dense("discriminator.dense.1", 64, 32)
            + _dense("discriminator.dense.2", 32, 1)
            + _dense("disc_head.dense", latent, latent))


def orced(dims: Dict, n_classes: int) -> List[Leaf]:
    latent = dims["SUP_LATENT_DIM"]
    ml: List[Leaf] = []
    for i, (a, b) in enumerate(zip((n_classes, 16, 32, 64), (16, 32, 64, latent))):
        ml += _dense(f"mean_learner.dense.{i}", a, b)
        if i < 3:
            ml += _norm(f"mean_learner.norm.{i}", b)
    return (backbone("encoder.backbone", dims)
            + _dense("encoder.MLP_mu", dims["DTC_FILTERS"][-1], latent)
            + _dense("encoder.MLP_logvar", dims["DTC_FILTERS"][-1], latent)
            + _dense("encoder.MLP_classification", latent, n_classes)
            + _decoder("decoder", latent, dims) + ml)


MODELS = {"pcaa_v4": pcaa_v4, "orced": orced, "pcaa_v4_encoder": pcaa_encoder}


def leaves(model: str, dims: Dict, n_classes: int) -> List[Leaf]:
    """The leaves of ``model``: its entry in ``MODELS``, or else
    ``leaves(dims, n_classes)`` of ``benchmark/reference/<model>.py``."""
    if model in MODELS:
        return MODELS[model](dims, n_classes)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), model + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no model {model!r}: neither in MODELS of {__file__} nor "
                                f"{path}")
    return importlib.import_module(f"{__package__}.{model}").leaves(dims, n_classes)


def make(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf drawn from one ``torch.rand`` of all their elements, made
    on ``device`` by a generator seeded from ``seed``: the same seed and
    device give the same values. The leaves are views of that one buffer."""
    total = sum(torch.Size(s).numel() for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, (lo, hi) in leaves:
        n = torch.Size(shape).numel()
        out[name] = flat[at:at + n].mul_(hi - lo).add_(lo).view(shape)
        at += n
    return out
