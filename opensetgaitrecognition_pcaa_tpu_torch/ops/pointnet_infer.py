"""Eval-mode PointNet stack + point pooling: BatchNorm folding, the plain
PyTorch version, and the wrapper of the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/pointnet_infer.py``.
In eval mode BatchNorm is a per-channel affine, so each of the 4 layers
folds into one ``W', b'`` and the stack becomes 4 x (matmul -> + b' -> ELU)
followed by the mean over the points of each frame:
``(B, T, N, C) -> (B, T, D)``.

``pointnet_pool_infer_op`` is the same function as the custom op
``osgr_torch::pointnet_pool_infer``, which ``torch.export`` records as one
node of a serving artifact's graph (a ctypes call cannot be traced): it
dispatches as the wrapper does, by the device of its tensors.

``pointnet_pool_infer`` launches ``csrc/pointnet_infer.cu`` for a CUDA
tensor and raises on anything the kernel does not take; for a CPU tensor it
computes ``pointnet_pool_ref``, the plain version that the tests and
``chip_smoke.py`` hold the kernel against. The kernel runs the four layers
on the tensor cores in the exact three-pass TF32 mode (``ops/tf32x3.py``),
on ``wgmma`` (``csrc/tf32x3_wgmma.cuh``).
The TPU kernel's VMEM budget, grid-size guard and precision routing are not
carried over: the CUDA kernel takes every shape the JAX wrapper takes, any
number of frames and points, any channels and any widths. The wrapper pads
each frame's points to a multiple of 16, and the channels C and the widths
H = D // 2 and D to multiples of 4, with zeros (``pad_widths``: a padded
width has zero weights and a zero bias, so it is ELU(0) = 0 in every layer
and adds exact zeros to the real widths' sums); it allocates the
activations of at most ``_PASS_ROWS`` padded points (fewer above D = 1024),
through which the kernel walks the batch, and the weights' TF32 planes (two
floats a weight: the kernel writes each weight transposed, split into hi
and lo, once a call), and slices the output back to D.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "pointnet_infer"
_GROUP = 16  # points per partial row of the pool: a warp's 16 rows of an m64 tile
# padded points per pass of the kernel: 256 crops of 30 frames x 150 points
# (1,228,800 padded) go in one pass, with 7.5 GB of activations at D = 1024;
# above D = 1024 a pass takes as many activation floats as at 1024
_PASS_ROWS = 1_310_720
_PASS_FLOATS = _PASS_ROWS * 1024
_WIDTHS = ("w1", "w2", "w3", "w4")
# the folded stack in the order the custom op takes it as a list
FOLDED_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")


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


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def pad_widths(x: torch.Tensor, folded: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Zero-pad the channels C of ``x`` ``(B, T, N, C)`` and the widths of
    the folded stack (C → H → H → D → D) to multiples of 4, as the kernel
    takes them → ``(x, folded)``; the inputs where nothing needs padding.
    Every padded term of a sum is an exact 0, and a padded output column
    is ELU(0) = 0; the first D columns are the function of the inputs."""
    widths = [folded["w1"].shape[0]] + [folded[k].shape[1] for k in _WIDTHS]
    padded = [_round4(w) for w in widths]
    if padded == widths:
        return x, folded
    out = {}
    for i, k in enumerate(_WIDTHS):
        w, b = folded[k], folded[f"b{i + 1}"]
        out[k] = F.pad(w, (0, padded[i + 1] - w.shape[1], 0, padded[i] - w.shape[0]))
        out[f"b{i + 1}"] = F.pad(b, (0, padded[i + 1] - b.shape[0]))
    return F.pad(x, (0, padded[0] - widths[0])), out


def _check_cuda_args(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> int:
    """Raise unless the kernel takes these arguments; return D."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, N, C), got shape {tuple(x.shape)}")
    c = x.shape[3]
    h = folded["w1"].shape[1]
    d = folded["w4"].shape[1]
    want = {
        "w1": (c, h), "b1": (h,), "w2": (h, h), "b2": (h,),
        "w3": (h, d), "b3": (d,), "w4": (d, d), "b4": (d,),
    }
    if c < 1 or h < 1 or h > d:
        raise ValueError(f"the kernel takes widths 1 <= H <= D and C >= 1, got C={c}, "
                         f"H={h}, D={d}")
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
    lib.tf32x3_split_planes_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.pointnet_pool_infer_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.tf32x3_epilogue_elu_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p]
    for fn in (lib.tf32x3_split_planes_f32, lib.pointnet_pool_infer_f32,
               lib.tf32x3_epilogue_elu_f32):
        fn.restype = ctypes.c_int
    return lib


def epilogue_elu(x: torch.Tensor) -> torch.Tensor:
    """``csrc/hopper.cuh``'s branch-free ELU, which the eval kernel's
    epilogues and the bf16 train layer's prologue inline, on a CUDA f32
    tensor, elementwise: what the card tests hold to ``F.elu``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("epilogue_elu takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().tf32x3_epilogue_elu_f32(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_infer ELU kernel launch failed: cudaError {err}")
    return out


def split_planes(folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's split of CUDA weights ``w1..w4`` (in, out), widths
    multiples of 4: for each layer in order, ``W^T``'s TF32 hi plane, then
    its lo plane (``ops/tf32x3.py::split_tf32``), ``(out, in)`` each, flat
    in one f32 tensor. One launch, on the current stream."""
    ws = [folded[k] for k in _WIDTHS]
    if any(w.device.type != "cuda" or w.dtype != torch.float32 or not w.is_contiguous()
           for w in ws):
        raise ValueError("split_planes takes contiguous float32 CUDA weights")
    planes = torch.empty(2 * sum(w.numel() for w in ws), dtype=torch.float32,
                         device=ws[0].device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _library().tf32x3_split_planes_f32(
            *(w.data_ptr() for w in ws), planes.data_ptr(), ws[0].shape[0], ws[0].shape[1],
            ws[3].shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"tf32x3_split_planes kernel launch failed: cudaError {err}")
    return planes


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
    b, t, n, _ = x.shape
    x, folded = pad_widths(x, folded)
    c, h, dp = x.shape[3], folded["w1"].shape[1], folded["w4"].shape[1]
    frames = b * t
    np_ = -(-n // _GROUP) * _GROUP
    xp = x.reshape(frames, n, c)
    if np_ != n:
        xp = F.pad(xp, (0, 0, 0, np_ - n))
    per_pass = max(1, min(frames, _PASS_ROWS // np_, _PASS_FLOATS // (np_ * dp)))
    rows = per_pass * np_
    planes = split_planes(folded)
    out = torch.empty((frames, dp), dtype=torch.float32, device=x.device)
    act_a = torch.empty((rows, dp), dtype=torch.float32, device=x.device)
    act_b = torch.empty((rows, h), dtype=torch.float32, device=x.device)
    partial = torch.empty((rows // _GROUP, dp), dtype=torch.float32, device=x.device)
    biases = [folded[f"b{i}"] for i in range(1, 5)]
    fn = _library().pointnet_pool_infer_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            xp.data_ptr(), planes.data_ptr(), *(v.data_ptr() for v in biases), out.data_ptr(),
            act_a.data_ptr(), act_b.data_ptr(), partial.data_ptr(),
            frames, n, np_, c, h, dp, per_pass, stream,
        )
    if err != 0:
        raise RuntimeError(f"pointnet_pool_infer kernel launch failed: cudaError {err}")
    pointnet_pool_infer.launches += 1
    out = out.reshape(b, t, dp)
    return out if dp == d else out[..., :d].contiguous()


# Kernel launches since the last reset; the plain path does not count.
pointnet_pool_infer.launches = 0


@torch.library.custom_op("osgr_torch::pointnet_pool_infer", mutates_args=())
def pointnet_pool_infer_op(x: torch.Tensor, weights: List[torch.Tensor]) -> torch.Tensor:
    """``pointnet_pool_infer`` as a custom op: ``weights`` is the folded
    stack as a list in ``FOLDED_KEYS`` order (a schema takes no dict). A
    CUDA tensor launches the kernel (counted) or raises; a CPU tensor takes
    the plain version."""
    folded = {k: w.contiguous() for k, w in zip(FOLDED_KEYS, weights)}
    return pointnet_pool_infer(x.contiguous(), folded)


@pointnet_pool_infer_op.register_fake
def _(x: torch.Tensor, weights: List[torch.Tensor]) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1], weights[-2].shape[1]))


def pointnet_pool_op(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``pointnet_pool_infer`` through the custom op, for a traced forward."""
    return pointnet_pool_infer_op(x, [folded[k] for k in FOLDED_KEYS])
