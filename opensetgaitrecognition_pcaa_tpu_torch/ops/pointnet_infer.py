"""Eval-mode PointNet stack + point pooling: BatchNorm folding, the plain
PyTorch version, and the wrapper of the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/pointnet_infer.py``.
In eval mode BatchNorm is a per-channel affine, so each of the 4 layers
folds into one ``W', b'`` and the stack becomes 4 x (matmul -> + b' -> ELU)
followed by the mean over the points of each frame:
``(B, T, N, C) -> (B, T, D)``.

``pointnet_pool_infer`` launches ``csrc/pointnet_infer.cu`` for a CUDA
tensor and raises on anything the kernel does not take; for a CPU tensor it
computes ``pointnet_pool_ref``, the plain version that the tests and
``chip_smoke.py`` hold the kernel against. The kernel runs the four layers
on the tensor cores in the exact three-pass TF32 mode (``ops/tf32x3.py``).
The TPU kernel's VMEM budget, grid-size guard and precision routing are not
carried over: the CUDA kernel takes any number of frames, points and
channels. The wrapper pads each frame's points to a multiple of 16 and the
channels to a multiple of 4 with zeros, hands the weights over transposed
(the kernel reads them K-major), and allocates the activations of at most
``_PASS_ROWS`` padded points, through which the kernel walks the batch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "pointnet_infer"
_GROUP = 16  # points per partial row of the pool: the kernel's m16 row tile
# padded points per pass of the kernel: 256 crops of 30 frames x 150 points
# (1,228,800 padded) go in one pass, with 7.5 GB of activations at D = 1024
_PASS_ROWS = 1_310_720


def fold_batchnorm(
    kernel: torch.Tensor,
    bias: torch.Tensor,
    scale: torch.Tensor,
    bn_bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding layer.

    ``kernel`` is ``(in, out)``, as the JAX package stores it:
    ``BN(xW + b) = x(W·s) + (b − μ)·s + β`` with ``s = γ/√(σ²+ε)``.
    """
    s = scale / torch.sqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


@torch.no_grad()
def folded_pointnet_params(block) -> Dict[str, torch.Tensor]:
    """Fold a port ``PointNetBlock``'s layers into ``w1..w4`` (in, out) and
    ``b1..b4``, contiguous f32 on the block's device."""
    out = {}
    for i, (dense, bn) in enumerate(zip(block.dense, block.norm), start=1):
        w, b = fold_batchnorm(
            dense.weight.t(), dense.bias, bn.scale, bn.bias, bn.mean, bn.var,
            bn.eps,
        )
        out[f"w{i}"] = w.contiguous()
        out[f"b{i}"] = b.contiguous()
    return out


def pointnet_pool_ref(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain version (port of ``_pointnet_pool_xla``): every layer's
    activations are materialized. ``(B, T, N, C) -> (B, T, D)``."""
    h = x.float()
    for i in range(1, 5):
        h = F.elu(torch.matmul(h, folded[f"w{i}"].float()) + folded[f"b{i}"].float())
    return h.mean(dim=2)


def _check_cuda_args(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> int:
    """Raise unless the kernel takes these arguments; return D."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, N, C), got shape {tuple(x.shape)}")
    c = x.shape[3]
    d = folded["w4"].shape[1]
    h = d // 2
    want = {
        "w1": (c, h), "b1": (h,), "w2": (h, h), "b2": (h,),
        "w3": (h, d), "b3": (d,), "w4": (d, d), "b4": (d,),
    }
    if d not in (512, 1024):
        raise ValueError(f"the kernel takes D in (512, 1024), got D={d}")
    if c < 1:
        raise ValueError(f"x has no channels: {tuple(x.shape)}")
    for name, t in [("x", x)] + [(k, folded[k]) for k in want]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")
    if x.shape[0] * x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"x has no frames or no points: {tuple(x.shape)}")
    return d


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    fn = lib.pointnet_pool_infer_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def pointnet_pool_infer(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fused eval PointNet + pool: ``(B, T, N, C) -> (B, T, D)``.

    ``folded``: ``w1..w4`` (in, out) and ``b1..b4``, BatchNorm folded in
    (``folded_pointnet_params``). A CPU tensor takes ``pointnet_pool_ref``;
    a CUDA tensor launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return pointnet_pool_ref(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    d = _check_cuda_args(x, folded)
    b, t, n, c = x.shape
    frames = b * t
    np_ = -(-n // _GROUP) * _GROUP
    c4 = -(-c // 4) * 4
    xp = x.reshape(frames, n, c)
    if (np_, c4) != (n, c):
        xp = F.pad(xp, (0, c4 - c, 0, np_ - n))
    w1 = folded["w1"]
    if c4 != c:
        w1 = F.pad(w1, (0, 0, 0, c4 - c))
    # the kernel reads the weights K-major: (out, in)
    wts = [w1.t().contiguous()] + [folded[f"w{i}"].t().contiguous() for i in range(2, 5)]
    per_pass = max(1, min(frames, _PASS_ROWS // np_))
    rows = per_pass * np_
    out = torch.empty((b, t, d), dtype=torch.float32, device=x.device)
    act_a = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    act_b = torch.empty((rows, d // 2), dtype=torch.float32, device=x.device)
    partial = torch.empty((rows // _GROUP, d), dtype=torch.float32, device=x.device)
    weights = [p for i in range(4) for p in (wts[i], folded[f"b{i + 1}"])]
    fn = _library().pointnet_pool_infer_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            xp.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(),
            act_a.data_ptr(), act_b.data_ptr(), partial.data_ptr(),
            frames, n, np_, c4, d, per_pass, stream,
        )
    if err != 0:
        raise RuntimeError(f"pointnet_pool_infer kernel launch failed: cudaError {err}")
    pointnet_pool_infer.launches += 1
    return out


# Kernel launches since the last reset; the plain path does not count.
pointnet_pool_infer.launches = 0
