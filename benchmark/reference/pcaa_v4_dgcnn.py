"""Plain PyTorch reference of PCAA V4 with a DGCNN encoder: its parameters by
name (``leaves``), the encoder in the published edge form, and the training
step that the cell ``pcaa_v4_dgcnn.train_b16`` compares the program with.

Written from DGCNN (Wang, Sun, Liu, Sarma, Bronstein and Solomon, ACM TOG
2019, arXiv 1801.07829; github.com/WangYueFt/dgcnn ``pytorch/model.py``,
``knn``, ``get_graph_feature``, class ``DGCNN``) and the contract in the
program's ``models/dgcnn.py``; the rest of the step is V4's (``model.py``,
the step of ``pcaa_v4_p4t.py`` with this encoder). Nothing here imports the
program, JAX or the JAX package; the caller turns TF32 off
(``model.exact_f32``) or, for the control, on.

Each EdgeConv layer as published: the kNN graph of the layer's input (its
own, the contract's arithmetic: ``Σ_c (x_ic − x_jc)²`` in channel order in
f32, each operation on its own, ties to the lower index), the edge tensor
``[x_j − x_i, x_i]`` of every point and neighbour, the bias-free 1×1 conv as
a product over its channels, BatchNorm over every edge (biased variance),
LeakyReLU and ``amax`` over the neighbours. At the cell's sizes the whole
step fits the card (the edges' autograd state is about 12 GB), so no frames
are blocked. ``encoder`` takes the graphs to use (the program's, so that
near-ties do not add noise to the other numbers) and records each layer's
input, its k-th smallest distance and its own graph, from which the cell
takes ``graph_gap``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as v4
from benchmark.reference.params import Leaf, _decoder, _dense, _norm
from benchmark.reference.pcaa_v4_p4t import pcaa_v4_p4t_step

P = Dict[str, torch.Tensor]
KEYS = ("K", "WIDTHS", "EMB_DIMS", "SLOPE", "BN_EPS", "BN_MOMENTUM")


def spec(dims: Dict) -> Dict:
    """The encoder's sizes from the configuration's ``DGCNN_*`` keys, by
    their names without the prefix, in lower case."""
    return {k.lower(): dims["DGCNN_" + k] for k in KEYS}


def _bound(fan_in: int) -> Tuple[float, float]:
    b = 1.0 / math.sqrt(fan_in)
    return (-b, b)


def encoder_leaves(dims: Dict, n_classes: int) -> List[Leaf]:
    s = spec(dims)
    widths, emb, latent = s["widths"], s["emb_dims"], dims["SUP_LATENT_DIM"]
    leaves: List[Leaf] = []
    for i, (c, o) in enumerate(zip([dims["NFEATURES"]] + list(widths[:-1]), widths)):
        leaves += [(f"encoder.edges.{i}.weight", (o, 2 * c), _bound(2 * c))]
        leaves += _norm(f"encoder.edges.{i}.norm", o)
    leaves += [("encoder.conv5.weight", (emb, sum(widths)), _bound(sum(widths)))]
    leaves += _norm("encoder.bn5", emb)
    filters = dims["DTC_FILTERS"]
    for i, (a, b) in enumerate(zip([2 * emb] + list(filters[:-1]), filters)):
        name = f"encoder.tcn.layers.{i}"
        leaves += [(name + ".conv.weight", (b, a, 3), _bound(3 * a)),
                   (name + ".conv.bias", (b,), _bound(3 * a))]
        leaves += _norm(name + ".norm", b)
    return (leaves + _dense("encoder.MLP_sup1", filters[-1], latent)
            + _dense("encoder.MLP_head", latent, latent // 2)
            + _dense("encoder.MLP_sup2", latent // 2, n_classes))


def leaves(dims: Dict, n_classes: int) -> List[Leaf]:
    """V4 with the discriminator projection head and a DGCNN encoder: the
    generator side (encoder, decoder head, decoder) and the critic side
    (critic, DPH), under the program's parameter names."""
    latent = dims["SUP_LATENT_DIM"]
    return (encoder_leaves(dims, n_classes)
            + _dense("dec_head.dense", latent, 2 * latent)
            + _decoder("decoder", 2 * latent, dims)
            + _dense("discriminator.dense.0", latent + n_classes, 64)
            + _dense("discriminator.dense.1", 64, 32)
            + _dense("discriminator.dense.2", 32, 1)
            + _dense("disc_head.dense", latent, latent))


# --- the graph -----------------------------------------------------------------------------------

def all_sq_dists(h: torch.Tensor) -> torch.Tensor:
    """``(F, N, C) → (F, N, N)`` squared distances in the contract's arithmetic."""
    d = torch.zeros(h.shape[:2] + h.shape[1:2], dtype=h.dtype, device=h.device)
    for c in range(h.shape[-1]):
        diff = h[..., c][:, :, None] - h[..., c][:, None, :]
        d = d + diff * diff
    return d


def sq_dists(h: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """``(F, N, C)`` and neighbours ``(F, N, S)`` → their squared distances
    ``(F, N, S)``, the same arithmetic."""
    rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
    d = torch.zeros(nb.shape, dtype=h.dtype, device=h.device)
    for c in range(h.shape[-1]):
        diff = h[..., c][:, :, None] - h[..., c][rows, nb]
        d = d + diff * diff
    return d


def knn(h: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(F, N, C)`` → (the ``min(k, N)`` nearest points of each point,
    nearest first, ties to the lower index; the k-th smallest distance)."""
    dist, order = torch.sort(all_sq_dists(h), dim=-1, stable=True)
    k = min(k, h.shape[1])
    return order[..., :k], dist[..., k - 1]


def graph_gap(graphs: List[List[torch.Tensor]], records: List[List[Dict]]) -> float:
    """The largest excess of a chosen neighbour's distance over the k-th
    smallest, both on the reference's features, relative to that k-th
    distance, over every step, layer and point; infinite where a graph does
    not fit the reference's layer."""
    worst = 0.0
    for step_graphs, step_records in zip(graphs, records):
        for g, rec in zip(step_graphs, step_records):
            h, kth = rec["input"], rec["kth"]
            if tuple(g.shape) != tuple(rec["graph"].shape):
                return math.inf
            excess = (sq_dists(h, g.to(h.device).long()) - kth[..., None]).clamp(min=0)
            rel = torch.where(excess > 0, excess / kth[..., None], torch.zeros_like(excess))
            worst = max(worst, float(rel.max()))
    return worst


# --- the encoder ---------------------------------------------------------------------------------

def batchnorm(p: P, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Train-mode BatchNorm over every axis but the last (biased variance)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims)
    var = ((x - mean) ** 2).mean(dim=dims)
    return (x - mean) / torch.sqrt(var + eps) * p[name + ".scale"] + p[name + ".bias"]


def edge_conv(p: P, name: str, h: torch.Tensor, idx: torch.Tensor, s: Dict) -> torch.Tensor:
    """The published EdgeConv layer on ``h (F, N, C)`` over the graph ``idx
    (F, N, k)`` → ``(F, N, O)``."""
    rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
    xj = h[rows, idx]                                                        # (F, N, k, C)
    xi = h[:, :, None, :].expand_as(xj)
    edges = torch.cat([xj - xi, xi], dim=-1) @ p[name + ".weight"].t()       # (F, N, k, O)
    z = batchnorm(p, name + ".norm", edges, s["bn_eps"])
    return F.leaky_relu(z, s["slope"]).amax(dim=2)


def tcn(p: P, h: torch.Tensor) -> torch.Tensor:
    """V4's TCN over ``(B, T, D)`` → the mean over time ``(B, filters[-1])``."""
    h = h.transpose(1, 2)
    for i, d in enumerate(v4.TCN_DILATIONS):
        name = f"encoder.tcn.layers.{i}"
        h = F.conv1d(F.pad(h, (2 * d, 0)), p[name + ".conv.weight"], p[name + ".conv.bias"],
                     dilation=d)
        h = F.elu(v4.batchnorm(p, name + ".norm", h.transpose(1, 2))).transpose(1, 2)
    return h.mean(dim=2)


def encoder(p: P, x: torch.Tensor, dims: Dict, graphs: Optional[List[torch.Tensor]] = None,
            record: Optional[List[Dict]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DGCNN encoder and PCAA's heads → ``(logits, latent)``; each layer
    on ``graphs[i]`` where given, else on its own graph; ``record`` gets
    each layer's input, k-th smallest distance and own graph."""
    s = spec(dims)
    b, t_len, n, c = x.shape
    h = x.reshape(b * t_len, n, c)
    ys = []
    for i in range(len(s["widths"])):
        own, kth = knn(h.detach(), s["k"])
        if record is not None:
            record.append({"input": h.detach(), "kth": kth, "graph": own})
        h = edge_conv(p, f"encoder.edges.{i}", h, own if graphs is None else graphs[i], s)
        ys.append(h)
    h = torch.cat(ys, dim=-1) @ p["encoder.conv5.weight"].t()
    h = F.leaky_relu(batchnorm(p, "encoder.bn5", h, s["bn_eps"]), s["slope"])
    pooled = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1).reshape(b, t_len, -1)
    fv = F.elu(v4.linear(p, "encoder.MLP_sup1", tcn(p, pooled)))
    return F.elu(v4.linear(p, "encoder.MLP_sup2", F.elu(v4.linear(p, "encoder.MLP_head", fv)))), fv


# --- the step ------------------------------------------------------------------------------------

def pcaa_v4_dgcnn_step(p: P, opt_g: Dict, opt_d: Dict, x: torch.Tensor, labels: torch.Tensor,
                       z0: torch.Tensor, alphas: torch.Tensor, centroids: torch.Tensor, hp: Dict,
                       graphs: Optional[List[torch.Tensor]] = None,
                       record: Optional[List[Dict]] = None) -> Tuple[Dict[str, float], P]:
    """One V4 step with the DGCNN encoder in place on ``p`` and the two Adam
    states → (losses, the gradients as each Adam gets them)."""
    return pcaa_v4_p4t_step(p, opt_g, opt_d, x, labels, z0, alphas, centroids, hp,
                            encode=lambda q, xx, d: encoder(q, xx, d, graphs, record))
