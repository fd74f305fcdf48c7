"""Plain PyTorch reference of PCAA V4 with a P4Transformer encoder: its
parameters by name (``leaves``), the encoder, and the training step that
the cell ``pcaa_v4_p4t.train_b16`` compares the program with.

Written from P4Transformer (Fan, Yang and Kankanhalli, CVPR 2021;
github.com/hehefan/P4Transformer ``models/msr.py``,
``modules/point_4d_convolution.py``, ``modules/transformer.py``) and the
contract in the program's ``models/p4t.py``; the rest of the step is V4's
(``model.py``). Nothing here imports the program, JAX or the JAX package;
the caller turns TF32 off (``model.exact_f32``) or, for the control, on.

In f32, at the published sizes on the card: farthest-point sampling loops
over its rounds for all frames at once; the ball query takes every point's
squared distance and keeps the first K inside by a running count; the tube
is materialised a crop at a time (the crop's 442 MB of samples × channels)
and maxed over the samples, then over the frames; attention is computed a
sequence at a time (the scores of 8 heads over 1,125 tokens are 40 MB).
Squared distances are ``((dx·dx + dy·dy) + dz·dz)`` with each operation on
its own, so the anchors and balls are the program's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as v4
from benchmark.reference.params import Leaf, _dense, _decoder

P = Dict[str, torch.Tensor]
LN_EPS = 1e-5
KEYS = ("RADIUS", "NSAMPLES", "SPATIAL_STRIDE", "TEMPORAL_KERNEL", "TEMPORAL_STRIDE",
        "TEMPORAL_PADDING", "DIM", "DEPTH", "HEADS", "DIM_HEAD", "MLP_DIM")


def spec(dims: Dict) -> Dict:
    """The encoder's sizes from the configuration's ``P4T_*`` keys, by their
    names without the prefix, in lower case."""
    return {k.lower(): dims["P4T_" + k] for k in KEYS}


def _layer_norm(name: str, width: int) -> List[Leaf]:
    return [(name + ".weight", (width,), (0.9, 1.1)), (name + ".bias", (width,), (-0.1, 0.1))]


def encoder_leaves(dims: Dict, n_classes: int) -> List[Leaf]:
    s = spec(dims)
    d, inner, latent = s["dim"], s["heads"] * s["dim_head"], dims["SUP_LATENT_DIM"]
    leaves = [("encoder.tube.conv_d", (d, 4), (-0.5, 0.5)),
              ("encoder.tube.conv_f", (d, 1), (-1.0, 1.0))]
    leaves += _dense("encoder.pos_embedding", 4, d)
    for i in range(s["depth"]):
        pre = f"encoder.transformer.{i}"
        b = 1.0 / math.sqrt(d)
        leaves += _layer_norm(pre + ".norm1", d) + [(pre + ".to_qkv.weight", (3 * inner, d),
                                                     (-b, b))]
        leaves += _dense(pre + ".to_out", inner, d) + _layer_norm(pre + ".norm2", d)
        leaves += _dense(pre + ".ff1", d, s["mlp_dim"]) + _dense(pre + ".ff2", s["mlp_dim"], d)
    return (leaves + _layer_norm("encoder.norm", d)
            + _dense("encoder.MLP_sup1", d, latent)
            + _dense("encoder.MLP_head", latent, latent // 2)
            + _dense("encoder.MLP_sup2", latent // 2, n_classes))


def leaves(dims: Dict, n_classes: int) -> List[Leaf]:
    """V4 with the discriminator projection head and a P4Transformer
    encoder: the generator side (encoder, decoder head, decoder) and the
    critic side (critic, DPH), under the program's parameter names."""
    latent = dims["SUP_LATENT_DIM"]
    return (encoder_leaves(dims, n_classes)
            + _dense("dec_head.dense", latent, 2 * latent)
            + _decoder("decoder", 2 * latent, dims)
            + _dense("discriminator.dense.0", latent + n_classes, 64)
            + _dense("discriminator.dense.1", 64, 32)
            + _dense("discriminator.dense.2", 32, 1)
            + _dense("disc_head.dense", latent, latent))


# --- the encoder ---------------------------------------------------------------------------------

def radius_sq(radius: float) -> float:
    r = np.float32(radius)
    return float(r * r)


def sq_dist(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    d = p[..., :3] - a[..., :3]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fps(p: torch.Tensor, m: int) -> torch.Tensor:
    """``(F, N, 3) → (F, m)``: from index 0, the point farthest from its
    nearest chosen anchor each round, the lowest index on a tie."""
    rows = torch.arange(p.shape[0], device=p.device)
    dist = torch.full(p.shape[:2], float("inf"), dtype=p.dtype, device=p.device)
    out = [torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)]
    for _ in range(1, m):
        dist = torch.minimum(dist, sq_dist(p, p[rows, out[-1]][:, None]))
        out.append(torch.argmax(dist, dim=1))
    return torch.stack(out, dim=1)


def geometry(t_len: int, s: Dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchor frames ``(L,)`` and each output frame's kernel frames
    ``(L, KT)``: padded frame i is frame ``clamp(i − pad, 0, T − 1)``."""
    kt, st, (pad0, pad1) = s["temporal_kernel"], s["temporal_stride"], s["temporal_padding"]
    l_len = (t_len + pad0 + pad1 - kt) // st + 1
    centre = kt // 2 + st * torch.arange(l_len, device=device)
    kernel = centre[:, None] + torch.arange(kt, device=device)[None, :] - kt // 2
    return centre - pad0, (kernel - pad0).clamp(0, t_len - 1)


def ball(frames: torch.Tensor, a: torch.Tensor, r2: float, k: int) -> torch.Tensor:
    """``frames (B, L, KT, N, 3)``, anchors ``a (B, L, M, 3)`` → ``(B, L, M,
    KT, K)``: the first K points inside, ascending; the rest of the slots the
    first found, or 0."""
    n = frames.shape[-2]
    inside = sq_dist(frames[:, :, None], a[:, :, :, None, None]) < r2      # (B, L, M, KT, N)
    rank = torch.cumsum(inside.long(), dim=-1) - 1
    keep = inside & (rank < k)
    out = torch.zeros(inside.shape[:-1] + (k + 1,), dtype=torch.int64, device=frames.device)
    idx = torch.arange(n, device=frames.device).expand_as(inside)
    out.scatter_(-1, torch.where(keep, rank, k), torch.where(keep, idx, 0))
    count = keep.sum(dim=-1, keepdim=True)
    return torch.where(torch.arange(k, device=frames.device) < count, out[..., :k], out[..., :1])


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(p: P, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def embed(p: P, x: torch.Tensor, s: Dict) -> torch.Tensor:
    """``(B, T, N, 4) → (B, L·M, D)``: the tube embedding plus the position
    embedding, frame-major."""
    b, t_len, n, _ = x.shape
    m, k = n // s["spatial_stride"], s["nsamples"]
    centres, kernel = geometry(t_len, s, x.device)
    l_len, kt = kernel.shape
    anchor_frames = x[:, centres]                                            # (B, L, N, 4)
    idx = fps(anchor_frames[..., :3].reshape(b * l_len, n, 3), m).reshape(b, l_len, m)
    a = torch.gather(anchor_frames[..., :3], 2, idx[..., None].expand(-1, -1, -1, 3))
    nb = x[:, kernel.reshape(-1)].reshape(b, l_len, kt, n, 4)
    balls = ball(nb[..., :3], a, radius_sq(s["radius"]), k)                 # (B, L, M, KT, K)
    w = torch.cat([p["encoder.tube.conv_d"], p["encoder.tube.conv_f"]], dim=1)
    dt = (torch.arange(kt, device=x.device, dtype=x.dtype) - kt // 2)[:, None, None]
    feats = []
    for i in range(b):  # a crop at a time: its samples x channels
        pts = _gather_crop(nb[i], balls[i])                                  # (L, M, KT, K, 4)
        u = torch.cat([pts[..., :3] - a[i][:, :, None, None], dt.expand(kt, k, 1)
                       .expand(l_len, m, kt, k, 1), pts[..., 3:]], dim=-1)
        feats.append((u @ w.t()).amax(dim=3).amax(dim=2))                    # (L, M, D)
    feat = torch.stack(feats)
    tau = torch.arange(1, l_len + 1, device=x.device, dtype=x.dtype)
    xyzt = torch.cat([a, tau[None, :, None, None].expand(b, l_len, m, 1)], dim=-1)
    pos = v4.linear(p, "encoder.pos_embedding", xyzt)
    return (feat + pos).reshape(b, l_len * m, -1)


def _gather_crop(nb: torch.Tensor, balls: torch.Tensor) -> torch.Tensor:
    """One crop's ball points: ``nb (L, KT, N, 4)``, ``balls (L, M, KT, K)``
    → ``(L, M, KT, K, 4)``."""
    l_len, m, kt, k = balls.shape
    src = nb[:, None].expand(l_len, m, kt, nb.shape[2], 4)
    return torch.gather(src, 3, balls[..., None].expand(-1, -1, -1, -1, 4))


def block(p: P, name: str, x: torch.Tensor, s: Dict) -> torch.Tensor:
    """A pre-norm block; attention a sequence at a time."""
    b, n, _ = x.shape
    heads, dh = s["heads"], s["dim_head"]
    qkv = layer_norm(p, name + ".norm1", x) @ p[name + ".to_qkv.weight"].t()
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    att = []
    for i in range(b):
        scores = (q[i] @ k[i].transpose(-1, -2)) / math.sqrt(dh)
        att.append(torch.softmax(scores, dim=-1) @ v[i])
    a = torch.stack(att).transpose(1, 2).reshape(b, n, heads * dh)
    x = x + gelu(v4.linear(p, name + ".to_out", a))
    h = gelu(v4.linear(p, name + ".ff1", layer_norm(p, name + ".norm2", x)))
    return x + gelu(v4.linear(p, name + ".ff2", h))


def encoder(p: P, x: torch.Tensor, dims: Dict,
            embed_fn: Callable = embed) -> Tuple[torch.Tensor, torch.Tensor]:
    """The P4Transformer encoder and PCAA's heads → ``(logits, latent)``."""
    s = spec(dims)
    h = embed_fn(p, x, s)
    for i in range(s["depth"]):
        h = block(p, f"encoder.transformer.{i}", h, s)
    feats = layer_norm(p, "encoder.norm", h.amax(dim=1))
    fv = F.elu(v4.linear(p, "encoder.MLP_sup1", feats))
    return F.elu(v4.linear(p, "encoder.MLP_sup2", F.elu(v4.linear(p, "encoder.MLP_head", fv)))), fv


# --- the step ------------------------------------------------------------------------------------

def pcaa_v4_p4t_step(p: P, opt_g: Dict, opt_d: Dict, x: torch.Tensor, labels: torch.Tensor,
                     z0: torch.Tensor, alphas: torch.Tensor, centroids: torch.Tensor, hp: Dict,
                     encode: Callable = encoder) -> Tuple[Dict[str, float], P]:
    """``model.pcaa_v4_step`` with the P4Transformer encoder (``encode(p, x,
    hp)``): one step in place on ``p`` and the two Adam states → (losses,
    the gradients as each Adam gets them)."""
    g_keys = [k for k in p if k.split(".")[0] in ("encoder", "dec_head", "decoder")]
    d_keys = [k for k in p if k.split(".")[0] in ("discriminator", "disc_head")]
    pg = {k: p[k].requires_grad_(True) for k in g_keys}
    pd = {k: p[k].requires_grad_(True) for k in d_keys}
    onehot = F.one_hot(labels.long(), centroids.shape[0]).float()
    logits, fv = encode(p, x, hp)
    z = (z0 + onehot @ centroids).detach()
    with torch.no_grad():
        fake = F.elu(v4.linear(p, "disc_head.dense", fv.detach()))
    interp = (z + alphas * (fake - z)).detach().requires_grad_(True)
    (gi,) = torch.autograd.grad(v4.critic(p, interp, onehot).sum(), interp, create_graph=True)
    gp = ((torch.sqrt((gi ** 2).sum(dim=1) + 1e-12) - 1.0) ** 2).mean()
    d_loss = (v4.critic(p, fake, onehot).mean() - v4.critic(p, z, onehot).mean()
              + hp["GP_WEIGHT"] * gp)
    d_grads = v4._grads(d_loss, pd)
    with torch.no_grad():
        v4.adam_(pd, d_grads, opt_d, lr=hp["LR"], b1=hp["B1"], b2=hp["B2"])

    rec = v4.decoder(p, "decoder", F.elu(v4.linear(p, "dec_head.dense", fv)), hp["shape"])
    rec_loss = v4.chamfer(rec, x)
    adv = -v4.critic(p, F.elu(v4.linear(p, "disc_head.dense", fv)), onehot).mean()
    sup = v4.cross_entropy(logits, labels)
    tot = rec_loss + adv * hp["ADV_WEIGHT"] + sup
    g_grads = v4._grads(tot, pg)
    with torch.no_grad():
        v4.adam_(pg, g_grads, opt_g, lr=hp["LR"], b1=hp["B1"], b2=hp["B2"])
    for w in p.values():
        w.requires_grad_(False)
    losses = {"d_loss": d_loss, "rec_loss": rec_loss, "sup_loss": sup, "tot_loss": tot}
    return {k: float(v.detach()) for k, v in losses.items()}, {**g_grads, **d_grads}
