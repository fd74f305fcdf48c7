"""Sequence Chamfer distance through the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/chamfer_kernel.py``.
``seq_chamfer_kernel`` is a drop-in for ``ops/chamfer.py::seq_chamfer``:
the per-frame sums ``(B, T)`` come from ``csrc/chamfer.cu`` for CUDA
tensors and from the plain ``frame_chamfer`` for CPU tensors; the mean over
T (or over everything) is taken here, as the JAX package takes it outside
its kernel. A CUDA tensor launches the kernel or raises. Unlike the TPU
kernel, which sends clouds of more than 640 points to XLA, the CUDA kernel
takes any N and M ≥ 1.

The gradient is a ``torch.autograd.Function`` whose backward is plain
torch, ported from the JAX package's XLA backward ``_chamfer_bt_bwd``: the
argmins are recomputed (``torch.argmin`` takes the first index on ties, as
``jnp.argmin`` does) and each nearest pair contributes ``2(y − x)``
through ``scatter_add_``.
"""

from __future__ import annotations

import ctypes

import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer, pairwise_sq_dists

_KERNEL = "chamfer"
_CHANNELS = (4, 5)  # a crop's channels: x, y, z, Doppler and, optionally, power in dB
_MAX_THREADS = 256


def _check_cuda_args(preds: torch.Tensor, gts: torch.Tensor) -> None:
    """Raise unless the kernel takes these arguments."""
    for name, t in (("preds", preds), ("gts", gts)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, N, C), got shape {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != preds.device:
            raise ValueError(f"{name} is on {t.device}, preds on {preds.device}")
    b, t, m, c = preds.shape
    if (gts.shape[0], gts.shape[1], gts.shape[3]) != (b, t, c):
        raise ValueError(f"preds {tuple(preds.shape)} and gts {tuple(gts.shape)} differ "
                         "in batch, time or channels")
    if c not in _CHANNELS:
        raise ValueError(f"the kernel takes {_CHANNELS} channels, got {c}")
    if b * t < 1 or m < 1 or gts.shape[2] < 1:
        raise ValueError(f"no frames or no points: preds {tuple(preds.shape)}, "
                         f"gts {tuple(gts.shape)}")


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    fn = lib.seq_chamfer_frames_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """The kernel's per-frame sums ``(B, T)``."""
    _check_cuda_args(preds, gts)
    b, t, m, c = preds.shape
    n = gts.shape[2]
    out = torch.empty((b, t), dtype=torch.float32, device=preds.device)
    threads = min(_MAX_THREADS, 32 * -(-max(n, m) // 32))
    fn = _library().seq_chamfer_frames_f32
    with torch.cuda.device(preds.device):
        stream = torch.cuda.current_stream(preds.device).cuda_stream
        err = fn(gts.data_ptr(), preds.data_ptr(), out.data_ptr(), b * t, n, m, c, threads,
                 stream)
    if err != 0:
        raise RuntimeError(f"seq_chamfer kernel launch failed: cudaError {err}")
    seq_chamfer_kernel.launches += 1
    return out


def _frame_chamfer_bwd(preds: torch.Tensor, gts: torch.Tensor, g: torch.Tensor):
    """VJP of the per-frame sums (port of ``_chamfer_bt_bwd``) →
    ``(d_preds, d_gts)``."""
    x = gts.float()
    y = preds.float()
    p = pairwise_sq_dists(x, y)  # (B, T, N, M)
    c = x.shape[-1]
    i_star = torch.argmin(p, dim=2)[..., None].expand(-1, -1, -1, c)  # nearest gt per pred
    j_star = torch.argmin(p, dim=3)[..., None].expand(-1, -1, -1, c)  # nearest pred per gt
    g = g[..., None, None].float()
    x_near = torch.gather(x, 2, i_star)  # (B, T, M, C)
    y_near = torch.gather(y, 2, j_star)  # (B, T, N, C)
    d_y_1 = 2.0 * (y - x_near) * g  # loss_1: min over gts, summed over preds
    d_x_2 = 2.0 * (x - y_near) * g  # loss_2: min over preds, summed over gts
    d_x_1 = torch.zeros_like(x).scatter_add_(2, i_star, -d_y_1)
    d_y_2 = torch.zeros_like(y).scatter_add_(2, j_star, -d_x_2)
    return (d_y_1 + d_y_2).to(preds.dtype), (d_x_1 + d_x_2).to(gts.dtype)


class _FrameChamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, preds, gts):
        ctx.save_for_backward(preds, gts)
        if preds.device.type == "cpu":
            return frame_chamfer(preds, gts)
        if preds.device.type != "cuda":
            raise ValueError(f"no kernel for device {preds.device}")
        return _launch(preds, gts)

    @staticmethod
    def backward(ctx, g):
        preds, gts = ctx.saved_tensors
        return _frame_chamfer_bwd(preds, gts, g)


def frame_chamfer_kernel(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Per-frame Chamfer sums ``(B, T)`` of ``preds`` ``(B, T, N, C)`` and
    ``gts`` ``(B, T, M, C)``: the kernel on the card, ``frame_chamfer`` on
    the CPU."""
    return _FrameChamfer.apply(preds, gts)


def seq_chamfer_kernel(preds: torch.Tensor, gts: torch.Tensor, avg_out: bool = True) -> torch.Tensor:
    """Drop-in for ``ops/chamfer.py::seq_chamfer`` through the kernel: a
    scalar mean over (batch, time) if ``avg_out``, else ``(B,)``."""
    total = frame_chamfer_kernel(preds, gts)
    if avg_out:
        return torch.mean(total)
    return torch.mean(total, dim=1)


# Kernel launches since the last reset; the plain path does not count.
seq_chamfer_kernel.launches = 0
