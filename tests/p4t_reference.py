"""A plain reference of the P4Transformer encoder (``models/p4t.py``'s
contract) written with loops and gathers, for the CPU tests at small sizes.

Plain ``torch`` in f32 (or the inputs' dtype); no kernel, and nothing of the
port is imported. Farthest-point sampling and the ball query walk each
frame's points in order as pointnet2's CUDA loops do; the tube takes each
token's samples, its features by a matrix product, and the max over the
samples of each frame, then over the frames; attention runs head by head.
The V4 step around the encoder is the benchmark's plain reference
(``benchmark/reference/pcaa_v4_p4t.py::pcaa_v4_p4t_step``), handed this
encoder.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import pcaa_v4_p4t as bench_ref

P = Dict[str, torch.Tensor]


def sq_dist(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``((dx·dx + dy·dy) + dz·dz)`` over the last axis, ``d = p − a``."""
    d = p[..., :3] - a[..., :3]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fps(points: torch.Tensor, m: int) -> List[int]:
    """One frame ``(N, ≥3)`` → m anchor indices."""
    dist = [math.inf] * points.shape[0]
    out = [0]
    for _ in range(1, m):
        d = sq_dist(points, points[out[-1]]).tolist()
        dist = [min(a, b) for a, b in zip(dist, d)]
        best = max(dist)
        out.append(dist.index(best))  # the first maximum
    return out


def ball(points: torch.Tensor, anchor: torch.Tensor, r2: float, k: int) -> List[int]:
    """The first k indices of one frame ``(N, ≥3)`` inside the ball, the
    slots left the first found, or 0."""
    d = sq_dist(points, anchor)
    r2 = torch.tensor(r2, dtype=d.dtype)
    found = [j for j in range(points.shape[0]) if bool(d[j] < r2)][:k]
    return found + [found[0] if found else 0] * (k - len(found))


def radius_sq(radius: float) -> float:
    r = np.float32(radius)
    return float(r * r)


def groups(x: torch.Tensor, s: Dict) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """``x (B, T, N, C)`` → anchors ``(B, L, M)``, balls ``(B, L, M, KT, K)``
    and the anchor frames."""
    b, t_len, n, _ = x.shape
    kt, st, (pad0, pad1) = s["temporal_kernel"], s["temporal_stride"], s["temporal_padding"]
    l_len = (t_len + pad0 + pad1 - kt) // st + 1
    m, k = n // s["spatial_stride"], s["nsamples"]
    centres = [kt // 2 + st * l for l in range(l_len)]  # padded frame indices
    anchors = torch.zeros((b, l_len, m), dtype=torch.int64)
    balls = torch.zeros((b, l_len, m, kt, k), dtype=torch.int64)
    for bi in range(b):
        for l, t in enumerate(centres):
            frame = x[bi, t - pad0]
            anchors[bi, l] = torch.tensor(fps(frame, m))
            for mi in range(m):
                a = frame[anchors[bi, l, mi]]
                for si, i in enumerate(range(t - kt // 2, t + kt // 2 + 1)):
                    nb = x[bi, min(max(i - pad0, 0), t_len - 1)]
                    balls[bi, l, mi, si] = torch.tensor(ball(nb, a, radius_sq(s["radius"]), k))
    return anchors, balls, [t - pad0 for t in centres]


def embed(p: P, x: torch.Tensor, s: Dict) -> torch.Tensor:
    """The tube embedding plus the position embedding → ``(B, L·M, D)``."""
    b, t_len, n, _ = x.shape
    anchors, balls, frames = groups(x, s)
    l_len, m, kt, k = balls.shape[1:]
    w_d, w_f = p["encoder.tube.conv_d"], p["encoder.tube.conv_f"]
    tokens = []
    for bi in range(b):
        for l, t in enumerate(frames):
            for mi in range(m):
                a = x[bi, t, anchors[bi, l, mi], :3]
                per_frame = []
                for si in range(kt):
                    nb = x[bi, min(max(t - kt // 2 + si, 0), t_len - 1)][balls[bi, l, mi, si]]
                    dt = torch.full((k, 1), float(si - kt // 2), dtype=x.dtype)
                    feat = torch.cat([nb[:, :3] - a, dt], dim=1) @ w_d.t() + nb[:, 3:] @ w_f.t()
                    per_frame.append(feat.amax(dim=0))
                feature = torch.stack(per_frame).amax(dim=0)
                xyzt = torch.cat([a, torch.tensor([l + 1.0], dtype=x.dtype)])
                pos = p["encoder.pos_embedding.weight"] @ xyzt + p["encoder.pos_embedding.bias"]
                tokens.append(feature + pos)
    return torch.stack(tokens).reshape(b, l_len * m, -1)


def layer_norm(p: P, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p[name + ".weight"] + p[name + ".bias"]


def linear(p: P, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def block(p: P, name: str, x: torch.Tensor, s: Dict) -> torch.Tensor:
    heads, dh = s["heads"], s["dim_head"]
    inner = heads * dh
    qkv = layer_norm(p, name + ".norm1", x) @ p[name + ".to_qkv.weight"].t()
    outs = []
    for h in range(heads):
        q = qkv[..., h * dh:(h + 1) * dh]
        k = qkv[..., inner + h * dh:inner + (h + 1) * dh]
        v = qkv[..., 2 * inner + h * dh:2 * inner + (h + 1) * dh]
        outs.append(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1) @ v)
    x = x + F.gelu(linear(p, name + ".to_out", torch.cat(outs, dim=-1)))
    return x + F.gelu(linear(p, name + ".ff2", F.gelu(linear(p, name + ".ff1",
                                                             layer_norm(p, name + ".norm2", x)))))


def encoder(p: P, x: torch.Tensor, dims: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, T, N, 4)`` → ``(logits, sup_fv)``: the embedding, the blocks,
    the max over tokens, the head LayerNorm and PCAA's heads."""
    s = bench_ref.spec(dims)
    h = embed(p, x, s)
    for i in range(s["depth"]):
        h = block(p, f"encoder.transformer.{i}", h, s)
    feats = layer_norm(p, "encoder.norm", h.amax(dim=1))
    fv = F.elu(linear(p, "encoder.MLP_sup1", feats))
    return F.elu(linear(p, "encoder.MLP_sup2", F.elu(linear(p, "encoder.MLP_head", fv)))), fv


def step(p: P, opt_g: Dict, opt_d: Dict, x, labels, z0, alphas, centroids, hp: Dict):
    """One V4 + P4Transformer step in place → (losses, gradients)."""
    return bench_ref.pcaa_v4_p4t_step(p, opt_g, opt_d, x, labels, z0, alphas, centroids, hp,
                                      encode=encoder)
