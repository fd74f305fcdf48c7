"""Sequence Chamfer distance through the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/chamfer_kernel.py``.
``seq_chamfer_kernel`` is a drop-in for ``ops/chamfer.py::seq_chamfer``:
the per-frame sums ``(B, T)`` come from ``csrc/chamfer.cu`` for CUDA
tensors and from the plain ``frame_chamfer`` for CPU tensors; the mean over
T (or over everything) is taken here, as the JAX package takes it outside
its kernel. A CUDA tensor launches the kernel or raises. Unlike the TPU
kernel, which sends clouds of more than 640 points to XLA, the CUDA kernel
takes any N and M ≥ 1, and any C ≥ 1: it is built for C = 4 and 5 (a
crop's channels) and 8, ``pad_channels`` pads fewer than 4 channels to 4
and 6 or 7 to 8 with zeros in both clouds (an exact 0 in every norm and
dot, so the same bits), and more than 8 go to a plain kernel that takes C
at run time (``csrc/chamfer.cu::chamfer_any_kernel``), slower but exact in
the same way. Both count as launches of the kernel.

The kernel computes each distance once, in one sweep over register tiles
(a thread holds R gt points and walks the pred points staged in shared
memory), and keeps both minima. ``launch_geometry`` picks R from N and the
warps per frame from the number of frames, so that both the 1920 frames of
an ``orced_inference`` chunk and the 480 of a serving request fill the
card; a frame's result does not depend on that choice. The wrapper's host
work per call is the argument checks, ``torch.empty`` and the ctypes call:
the ctypes function is resolved once and the geometry is cached per shape.

The gradient is a ``torch.autograd.Function`` whose backward is plain
torch, ported from the JAX package's XLA backward ``_chamfer_bt_bwd``: the
argmins are recomputed (``torch.argmin`` takes the first index on ties, as
``jnp.argmin`` does) and each nearest pair contributes ``2(y − x)``
through ``scatter_add_``. Without a gradient to record, the forward skips
the Function.

``seq_chamfer_op`` is ``seq_chamfer_kernel(..., avg_out=False)`` as the
custom op ``osgr_torch::seq_chamfer``, which ``torch.export`` records as one
node of a serving artifact's graph: it dispatches by device as the wrapper
does, and has no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer, pairwise_sq_dists

_KERNEL = "chamfer"
# the channel counts the tiled kernel is built for: a crop's x, y, z, Doppler
# and, optionally, power in dB; and 8, which 6 and 7 are padded to
_CHANNELS = (4, 5, 8)

# The kernel's fixed shape (csrc/chamfer.cu): a warp is 16 row lanes x 2
# column lanes; a thread holds R rows, one of ROWS_PER_THREAD (16 x 10 =
# 160 rows cover the published NMAX = 150 in one pass).
ROW_LANES, COL_LANES = 16, 2
COL_GROUP = 8  # pred points a column lane takes in a step
ROWS_PER_THREAD = (1, 2, 4, 6, 10)
WARPS_PER_FRAME = (1, 2, 4, 8)
COL_TILE = 1024  # staged pred points per tile at most
SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block may take without opting in
SMS = 132  # streaming multiprocessors of an H100 SXM
WARPS_PER_SM = 12  # warps the geometry aims to give each SM


class Geometry(NamedTuple):
    """One launch's shape: ``rows_per_thread`` gt points a thread holds,
    ``warps`` per frame (one block a frame), ``tile_cap`` pred points staged
    at once, ``smem_bytes`` of dynamic shared memory, and
    ``scratch_floats`` of device memory for the per-point minima (0 when
    they fit in shared memory)."""

    rows_per_thread: int
    warps: int
    tile_cap: int
    smem_bytes: int
    scratch_floats: int


@functools.lru_cache(maxsize=64)
def launch_geometry(frames: int, n: int, m: int, c: int) -> Geometry:
    """The kernel's launch geometry for ``frames`` frames of ``n`` gt and
    ``m`` pred points of ``c`` channels, as ``csrc/chamfer.cu`` lays out
    its shared memory."""
    rows = next((r for r in ROWS_PER_THREAD if ROW_LANES * r >= n), ROWS_PER_THREAD[-1])
    want = -(-SMS * WARPS_PER_SM // frames)
    warps = next((w for w in WARPS_PER_FRAME if w >= want), WARPS_PER_FRAME[-1])
    step = COL_GROUP * COL_LANES * warps
    tile_cap = min(-(-m // step) * step, COL_TILE)
    floats = tile_cap * (c + 2) + warps * ROW_LANES * rows
    scratch = 0
    if 4 * (floats + n + m) <= SMEM_LIMIT:
        floats += n + m
    else:
        scratch = frames * (n + m)
    return Geometry(rows, warps, tile_cap, 4 * floats, scratch)


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
    if c < 1:
        raise ValueError(f"no channels: preds {tuple(preds.shape)}")
    if b * t < 1 or m < 1 or gts.shape[2] < 1:
        raise ValueError(f"no frames or no points: preds {tuple(preds.shape)}, "
                         f"gts {tuple(gts.shape)}")


def kernel_channels(c: int) -> int:
    """The channel count the kernel runs ``c`` channels at: the smallest of
    ``_CHANNELS`` that holds them, or ``c`` itself above 8 (the run-time-C
    kernel)."""
    return next((k for k in _CHANNELS if k >= c), c)


def pad_channels(preds: torch.Tensor, gts: torch.Tensor):
    """Zero-pad the channels of both clouds to ``kernel_channels`` →
    ``(preds, gts)``; the inputs where nothing needs padding. A padded
    channel adds an exact 0 to every norm and dot product."""
    c = preds.shape[-1]
    extra = kernel_channels(c) - c
    if extra == 0:
        return preds, gts
    return F.pad(preds, (0, extra)), F.pad(gts, (0, extra))


# the C entry points, each with the number of int arguments it takes after
# its four pointers: the tiled kernel and the run-time-C kernel
_ENTRY_INTS = {"seq_chamfer_frames_f32": 8, "seq_chamfer_frames_any_f32": 4}
_FNS: Dict[str, Callable[..., int]] = {}


def _kernel(name: str = "seq_chamfer_frames_f32") -> Callable[..., int]:
    """A C entry point, built, loaded and typed at its first call."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load_library(_KERNEL), name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * _ENTRY_INTS[name]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """The kernel's per-frame sums ``(B, T)``."""
    _check_cuda_args(preds, gts)
    preds, gts = pad_channels(preds, gts)
    b, t, m, c = preds.shape
    n = gts.shape[2]
    device = preds.device
    out = torch.empty((b, t), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if c in _CHANNELS:
        geo = launch_geometry(b * t, n, m, c)
        scratch = (torch.empty(geo.scratch_floats, dtype=torch.float32, device=device)
                   if geo.scratch_floats else None)
        fn = _kernel()
        args = (gts.data_ptr(), preds.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b * t, n, m, c,
                geo.rows_per_thread, geo.warps, geo.tile_cap, geo.smem_bytes, stream)
    else:
        scratch = torch.empty(b * t * (n + m), dtype=torch.float32, device=device)
        fn = _kernel("seq_chamfer_frames_any_f32")
        args = (gts.data_ptr(), preds.data_ptr(), out.data_ptr(), scratch.data_ptr(), b * t,
                n, m, c, stream)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"seq_chamfer kernel launch failed: cudaError {err}")
    seq_chamfer_kernel.launches += 1
    return out


def _forward(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    if preds.device.type == "cpu":
        return frame_chamfer(preds, gts)
    if preds.device.type != "cuda":
        raise ValueError(f"no kernel for device {preds.device}")
    return _launch(preds, gts)


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
        return _forward(preds, gts)

    @staticmethod
    def backward(ctx, g):
        preds, gts = ctx.saved_tensors
        return _frame_chamfer_bwd(preds, gts, g)


def frame_chamfer_kernel(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Per-frame Chamfer sums ``(B, T)`` of ``preds`` ``(B, T, N, C)`` and
    ``gts`` ``(B, T, M, C)``: the kernel on the card, ``frame_chamfer`` on
    the CPU."""
    if torch.is_grad_enabled() and (preds.requires_grad or gts.requires_grad):
        return _FrameChamfer.apply(preds, gts)
    return _forward(preds, gts)


def seq_chamfer_kernel(preds: torch.Tensor, gts: torch.Tensor, avg_out: bool = True) -> torch.Tensor:
    """Drop-in for ``ops/chamfer.py::seq_chamfer`` through the kernel: a
    scalar mean over (batch, time) if ``avg_out``, else ``(B,)``."""
    total = frame_chamfer_kernel(preds, gts)
    if avg_out:
        return torch.mean(total)
    return torch.mean(total, dim=1)


# Kernel launches since the last reset; the plain path does not count.
seq_chamfer_kernel.launches = 0


@torch.library.custom_op("osgr_torch::seq_chamfer", mutates_args=())
def seq_chamfer_op(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Per-sample Chamfer ``(B,)``: ``seq_chamfer_kernel(preds, gts,
    avg_out=False)`` as a custom op. A CUDA tensor launches the kernel
    (counted) or raises; a CPU tensor takes the plain version."""
    return seq_chamfer_kernel(preds.contiguous(), gts.contiguous(), avg_out=False)


@seq_chamfer_op.register_fake
def _(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    return preds.new_empty((preds.shape[0],))
