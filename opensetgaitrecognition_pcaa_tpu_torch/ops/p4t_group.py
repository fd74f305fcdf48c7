"""Point grouping of P4Transformer's tube embedding: farthest-point
sampling and the ball query, the plain PyTorch versions and the wrappers of
the hand-written CUDA kernels (``csrc/p4t_group.cu``).

No TPU kernel is ported here: the JAX package has no P4Transformer. Both
functions follow pointnet2's CUDA ops as the published P4Transformer calls
them (``modules/point_4d_convolution.py``), with the contract of
``models/p4t.py``:

- ``furthest_point_sample``: from index 0, each next anchor is the point
  with the largest squared distance to its nearest chosen anchor; the
  minimum runs over every point, chosen ones included, and ties go to the
  lowest index (``torch.argmax``), which matters because frames are padded
  by repeating points;
- ``ball_query``: per anchor and per frame of the temporal kernel, the
  first K indices in ascending order with squared distance below r², the
  slots left filled with the first index found, or 0 where none is.

Squared distances are ``((dx·dx + dy·dy) + dz·dz)`` in f32 with ``d = p −
a``, each operation rounded on its own; the kernels round the same way
(``__fsub_rn``, ``__fmul_rn``, ``__fadd_rn``), so their indices are the plain
versions' bit for bit. ``radius_sq`` gives r² as both compare it: the f32
square of the f32 radius.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Each wrapper counts its kernel launches (``.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "p4t_group"


def radius_sq(radius: float) -> float:
    """r² as the kernels and the plain versions compare it: f32(r)·f32(r)
    rounded to f32."""
    r = np.float32(radius)
    return float(r * r)


def sq_dist(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``((dx·dx + dy·dy) + dz·dz)`` of ``d = p − a`` over the last axis (the
    first three channels), each operation on its own."""
    d = p[..., :3] - a[..., :3]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def neighbour_frames(t_len: int, l_len: int, kt: int, stride: int, pad: int) -> torch.Tensor:
    """``(L, KT)`` the frame of each output frame's temporal kernel: padded
    frame ``stride·l + s`` (frame 0 repeated ``pad`` times in front, the
    last frame at the back) is frame ``clamp(stride·l + s − pad, 0, T − 1)``."""
    frames = stride * torch.arange(l_len)[:, None] + torch.arange(kt)[None, :] - pad
    return frames.clamp(0, t_len - 1)


def furthest_point_sample_ref(points: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version: ``(..., N, C≥3) → (..., m)`` int64 anchor indices."""
    lead, n = points.shape[:-2], points.shape[-2]
    p = points[..., :3].reshape(-1, n, 3)
    rows = torch.arange(p.shape[0], device=p.device)
    out = torch.zeros((p.shape[0], m), dtype=torch.int64, device=p.device)
    dist = torch.full((p.shape[0], n), float("inf"), dtype=p.dtype, device=p.device)
    old = out[:, 0]
    for j in range(1, m):
        dist = torch.minimum(dist, sq_dist(p, p[rows, old][:, None, :]))
        old = torch.argmax(dist, dim=1)
        out[:, j] = old
    return out.reshape(lead + (m,))


def ball_query_ref(x: torch.Tensor, anchor: torch.Tensor, radius: float, k: int, kt: int,
                   stride: int, pad: int) -> torch.Tensor:
    """Plain version: ``x (B, T, N, C)``, ``anchor (B, L, M)`` (indices into
    frame ``stride·l + KT//2 − pad``) → ``(B, L, M, KT, K)`` int64."""
    b, t_len, n, _ = x.shape
    l_len = anchor.shape[1]
    frames = neighbour_frames(t_len, l_len, kt, stride, pad).to(x.device)
    a_frames = x[:, stride * torch.arange(l_len, device=x.device) + kt // 2 - pad]
    a = torch.gather(a_frames[..., :3], 2, anchor[..., None].expand(-1, -1, -1, 3))
    nb = x[:, frames.reshape(-1)].reshape(b, l_len, 1, kt, n, -1)      # (B, L, 1, KT, N, C)
    inside = sq_dist(nb, a[:, :, :, None, None, :]) < radius_sq(radius)  # (B, L, M, KT, N)
    rank = torch.cumsum(inside.long(), dim=-1) - 1
    found = inside & (rank < k)
    idx = torch.arange(n, device=x.device).expand_as(inside)
    slots = torch.where(found, rank, k)          # slot k: a bin for the points not kept
    out = torch.zeros(inside.shape[:-1] + (k + 1,), dtype=torch.int64, device=x.device)
    out.scatter_(-1, slots, torch.where(found, idx, 0))
    out = out[..., :k]
    count = found.sum(dim=-1, keepdim=True)
    first = out[..., :1]
    return torch.where(torch.arange(k, device=x.device) < count, out, first)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    lib.p4t_fps.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.p4t_fps.restype = ctypes.c_int
    lib.p4t_ball_query.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.p4t_ball_query.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the points on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def furthest_point_sample(points: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, F, N, C≥3) → (B, F, m)`` int64: farthest-point sampling of each
    frame's first three channels. On a CUDA tensor the frames may be a
    strided view (every second frame of a crop), each frame's ``(N, C)``
    contiguous."""
    if points.dim() != 4 or points.shape[-1] < 3:
        raise ValueError(f"points must be (B, F, N, C>=3), got {tuple(points.shape)}")
    b, f, n, c = points.shape
    if not 1 <= m <= n:
        raise ValueError(f"cannot sample {m} anchors of {n} points")
    if points.device.type == "cpu":
        return furthest_point_sample_ref(points, m)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    _check_cuda("points", points, torch.float32, points.device)
    if points.stride(3) != 1 or points.stride(2) != c:
        raise ValueError("each frame's (N, C) points must be contiguous")
    out = torch.empty((b, f, m), dtype=torch.int64, device=points.device)
    with torch.cuda.device(points.device):
        err = _library().p4t_fps(points.data_ptr(), points.stride(0), points.stride(1), c,
                                 b * f, f, n, m, out.data_ptr(),
                                 torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p4t_fps kernel launch failed: cudaError {err}")
    furthest_point_sample.launches += 1
    return out


def ball_query(x: torch.Tensor, anchor: torch.Tensor, radius: float, k: int, kt: int = 3,
               stride: int = 2, pad: int = 1) -> torch.Tensor:
    """``x (B, T, N, C≥3)``, ``anchor (B, L, M)`` int64 (indices into frame
    ``stride·l + KT//2 − pad``) → ``(B, L, M, KT, K)`` int64: the ball of each
    anchor on each frame of its temporal kernel, all frames at once."""
    check_geometry(x.shape, anchor.shape, kt, stride, pad)
    if not 1 <= k:
        raise ValueError(f"a ball takes at least one slot, got K = {k}")
    if x.device.type == "cpu":
        return ball_query_ref(x, anchor, radius, k, kt, stride, pad)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda("x", x, torch.float32, x.device)
    _check_cuda("anchor", anchor, torch.int64, x.device)
    if not (x.is_contiguous() and anchor.is_contiguous()):
        raise ValueError("x and anchor must be contiguous")
    b, t_len, n, c = x.shape
    l_len, m = anchor.shape[1:]
    out = torch.empty((b, l_len, m, kt, k), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().p4t_ball_query(x.data_ptr(), anchor.data_ptr(), b, t_len, n, c, l_len,
                                        m, kt, stride, pad, radius_sq(radius), k,
                                        out.data_ptr(),
                                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p4t_ball_query kernel launch failed: cudaError {err}")
    ball_query.launches += 1
    return out


def check_geometry(x_shape: Tuple[int, ...], anchor_shape: Tuple[int, ...], kt: int,
                   stride: int, pad: int) -> None:
    """Raise unless ``anchor`` has a crop's output frames: ``L`` frames of
    anchors on ``(B, T, N, C≥3)`` crops whose anchor frames are real frames."""
    if len(x_shape) != 4 or x_shape[-1] < 3:
        raise ValueError(f"x must be (B, T, N, C>=3), got {tuple(x_shape)}")
    if len(anchor_shape) != 3 or anchor_shape[0] != x_shape[0]:
        raise ValueError(f"anchor must be (B, L, M), got {tuple(anchor_shape)}")
    l_len = anchor_shape[1]
    if not 0 <= pad <= kt // 2 or stride * (l_len - 1) + kt // 2 - pad >= x_shape[1]:
        raise ValueError(f"{l_len} output frames of kernel {kt}, stride {stride} and front pad "
                         f"{pad} do not fit {x_shape[1]} frames")


# Kernel launches since the last reset; the plain versions do not count.
furthest_point_sample.launches = 0
ball_query.launches = 0
