"""The tube embedding of P4Transformer (P4DConv, ``operator '+'``, max
pooling in space and time): the plain PyTorch version, the wrapper of the
hand-written CUDA kernels (``csrc/p4t_tube.cu``) and the autograd Function.

No TPU kernel is ported here: the JAX package has no P4Transformer. For
each token (crop, output frame l, anchor a) and channel c::

    out[c] = max over the KT·K samples i of  W_d[c]·(p_j − a, s − KT//2) + W_f[c]·f_j

where sample ``i = s·K + k`` is slot k of the anchor's ball on frame s of
its temporal kernel (``ops/p4t_group.py``), ``p_j`` the point's position and
``f_j`` its Doppler. The dot product is formed as ``((((w0·u0 + w1·u1) +
w2·u2) + w3·u3) + w4·u4)`` over ``u = (dx, dy, dz, dt, f)``, each operation
rounded on its own, in the plain version and in the kernel alike, so the
kernel's maxima and argmaxes are the plain version's bits. The argmax is
the first maximal sample.

``tube_embed`` is a ``torch.autograd.Function``: its forward keeps the
``(tokens, D)`` maxima and a one-byte argmax, never the ``(tokens, KT·K,
D)`` tube (7.08 GB at the published sizes); its backward gives ``W_d`` and
``W_f`` their gradients from the argmax samples and the crop none. A CUDA
tensor launches the kernels or raises; a CPU tensor takes the plain
versions, which take f64 too (``gradcheck``). The wrapper counts its
launches (``.launches``: forwards and backwards).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_group import check_geometry, neighbour_frames

_KERNEL = "p4t_tube"
MAX_SAMPLES = 256  # the argmax is one byte


def samples(x: torch.Tensor, anchor: torch.Tensor, ball: torch.Tensor, kt: int, stride: int,
            pad: int) -> torch.Tensor:
    """``(B, L, M, KT·K, 5)`` the sample vectors ``u = (p_j − a, s − KT//2,
    f_j)`` of every token."""
    b, t_len, n, c = x.shape
    l_len, m, _, k = ball.shape[1:]
    frames = neighbour_frames(t_len, l_len, kt, stride, pad).to(x.device)  # (L, KT)
    a_frames = x[:, stride * torch.arange(l_len, device=x.device) + kt // 2 - pad]
    a = torch.gather(a_frames[..., :3], 2, anchor[..., None].expand(-1, -1, -1, 3))
    flat = x.reshape(b, t_len * n, c)
    rows = frames[None, :, None, :, None] * n + ball                        # (B, L, M, KT, K)
    p = torch.gather(flat, 1, rows.reshape(b, -1, 1).expand(-1, -1, c)).reshape(
        b, l_len, m, kt, k, c)
    dt = (torch.arange(kt, device=x.device, dtype=x.dtype) - kt // 2)[:, None].expand(kt, k)
    u = torch.cat([p[..., :3] - a[:, :, :, None, None, :],
                   dt.expand(b, l_len, m, kt, k)[..., None], p[..., 3:4]], dim=-1)
    return u.reshape(b, l_len, m, kt * k, 5)


def _dot(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(..., 5) · (D, 5) → (..., D)`` in the kernel's order of operations."""
    v = u[..., 0, None] * w[:, 0]
    for e in range(1, 5):
        v = v + u[..., e, None] * w[:, e]
    return v


def tube_forward_ref(x: torch.Tensor, anchor: torch.Tensor, ball: torch.Tensor,
                     w: torch.Tensor, kt: int, stride: int, pad: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: ``w = [W_d | W_f]`` (D, 5) → the maxima
    ``(B, L, M, D)`` and the first maximal samples ``(B, L, M, D)`` uint8,
    by a running max over the samples (strict ``>``)."""
    u = samples(x, anchor, ball, kt, stride, pad)
    best = _dot(u[..., 0, :], w)
    arg = torch.zeros(best.shape, dtype=torch.uint8, device=x.device)
    for i in range(1, u.shape[-2]):
        v = _dot(u[..., i, :], w)
        more = v > best
        best = torch.where(more, v, best)
        arg = torch.where(more, i, arg).to(torch.uint8)
    return best, arg


def tube_backward_ref(x: torch.Tensor, anchor: torch.Tensor, ball: torch.Tensor,
                      grad: torch.Tensor, arg: torch.Tensor, kt: int, stride: int, pad: int
                      ) -> torch.Tensor:
    """Plain version of the weight gradient: ``(D, 5)``, each channel's sum
    over the tokens of its gradient times its argmax sample's ``u``."""
    u = samples(x, anchor, ball, kt, stride, pad)                  # (B, L, M, S, 5)
    picked = torch.gather(u, 3, arg.long()[..., None].expand(-1, -1, -1, -1, 5))
    return torch.einsum("blmd,blmde->de", grad, picked)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    geometry = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    lib.p4t_tube_forward.argtypes = (geometry + [ctypes.c_void_p, ctypes.c_int]
                                     + [ctypes.c_void_p] * 3)
    lib.p4t_tube_forward.restype = ctypes.c_int
    lib.p4t_tube_backward.argtypes = (geometry + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                                      + [ctypes.c_void_p] * 3)
    lib.p4t_tube_backward.restype = ctypes.c_int
    lib.p4t_tube_chunks.argtypes = [ctypes.c_int]
    lib.p4t_tube_chunks.restype = ctypes.c_int
    return lib


def _geometry(x, anchor, ball, kt, stride, pad):
    b, t_len, n, _ = x.shape
    l_len, m, _, k = ball.shape[1:]
    return [x.data_ptr(), anchor.data_ptr(), ball.data_ptr(), b, t_len, n, l_len, m, kt, k,
            stride, pad]


def _check_cuda(x, anchor, ball, w) -> None:
    for name, t, dtype in (("x", x, torch.float32), ("anchor", anchor, torch.int64),
                           ("ball", ball, torch.int64), ("w", w, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class TubeEmbed(torch.autograd.Function):
    """``(x, anchor, ball, W_d, W_f) → (B, L, M, D)``; gradients for ``W_d``
    and ``W_f`` only."""

    @staticmethod
    def forward(ctx, x, anchor, ball, w_d, w_f, kt, stride, pad):
        w = torch.cat([w_d, w_f], dim=1).contiguous()
        if x.device.type == "cpu":
            out, arg = tube_forward_ref(x, anchor, ball, w, kt, stride, pad)
        else:
            _check_cuda(x, anchor, ball, w)
            b, _, _, _ = x.shape
            l_len, m = anchor.shape[1:]
            out = torch.empty((b, l_len, m, w.shape[0]), dtype=torch.float32, device=x.device)
            arg = torch.empty(out.shape, dtype=torch.uint8, device=x.device)
            with torch.cuda.device(x.device):
                err = _library().p4t_tube_forward(
                    *_geometry(x, anchor, ball, kt, stride, pad), w.data_ptr(), w.shape[0],
                    out.data_ptr(), arg.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"p4t_tube forward kernel launch failed: cudaError {err}")
            tube_embed.launches += 1
        ctx.save_for_backward(x, anchor, ball, arg)
        ctx.geometry = (kt, stride, pad, w_d.shape[1])
        return out

    @staticmethod
    def backward(ctx, grad):
        x, anchor, ball, arg = ctx.saved_tensors
        kt, stride, pad, n_d = ctx.geometry
        grad = grad.contiguous()
        if x.device.type == "cpu":
            dw = tube_backward_ref(x, anchor, ball, grad, arg, kt, stride, pad)
        else:
            lib = _library()
            d = grad.shape[-1]
            chunks = lib.p4t_tube_chunks(grad.numel() // d)
            partial = torch.empty((chunks, d, 5), dtype=torch.float32, device=x.device)
            dw = torch.empty((d, 5), dtype=torch.float32, device=x.device)
            with torch.cuda.device(x.device):
                err = lib.p4t_tube_backward(
                    *_geometry(x, anchor, ball, kt, stride, pad), grad.data_ptr(),
                    arg.data_ptr(), d, partial.data_ptr(), dw.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"p4t_tube backward kernel launch failed: cudaError {err}")
            tube_embed.launches += 1
        return None, None, None, dw[:, :n_d], dw[:, n_d:], None, None, None


def tube_embed(x: torch.Tensor, anchor: torch.Tensor, ball: torch.Tensor, w_d: torch.Tensor,
               w_f: torch.Tensor, kt: int = 3, stride: int = 2, pad: int = 1) -> torch.Tensor:
    """The tube embedding of crops ``x (B, T, N, 4)`` (positions, Doppler)
    at ``anchor (B, L, M)`` with balls ``(B, L, M, KT, K)``: ``W_d`` (D, 4)
    on the displacements, ``W_f`` (D, 1) on the Doppler → ``(B, L, M, D)``."""
    check_geometry(x.shape, anchor.shape, kt, stride, pad)
    if x.shape[-1] != 4 or w_d.shape[1] != 4 or w_f.shape[1] != 1 or w_d.shape[0] != w_f.shape[0]:
        raise ValueError(f"the tube takes (B, T, N, 4) crops, W_d (D, 4) and W_f (D, 1), got "
                         f"{tuple(x.shape)}, {tuple(w_d.shape)}, {tuple(w_f.shape)}")
    if ball.shape[:3] != anchor.shape or ball.shape[3] != kt:
        raise ValueError(f"ball {tuple(ball.shape)} does not match anchor "
                         f"{tuple(anchor.shape)} and kernel {kt}")
    if kt * ball.shape[4] > MAX_SAMPLES:
        raise ValueError(f"{kt} x {ball.shape[4]} samples a token; the argmax holds "
                         f"{MAX_SAMPLES}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return TubeEmbed.apply(x, anchor, ball, w_d, w_f, kt, stride, pad)


# Kernel launches since the last reset (forwards and backwards); the plain
# versions do not count.
tube_embed.launches = 0
