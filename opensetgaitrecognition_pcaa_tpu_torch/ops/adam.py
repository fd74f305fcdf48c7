"""One-pass Adam over a parameter dict: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/adam_kernel.py``
(``fused_adam_tree_update``). Per leaf, with ``t = count + 1``,
``s1 = lr / (1 − b1^t)`` and ``s2 = 1 / (1 − b2^t)`` computed in f32:

    m' = b1·m + (1 − b1)·g
    v' = b2·v + (1 − b2)·g²
    w' = w − (s1·m') / (√(v'·s2) + eps)

2-D leaves of at least ``min_kernel_elems`` elements (2²¹, the JAX
package's own rule: the four big decoder matrices at the published widths)
go through ``adam_update_``, which launches ``csrc/adam.cu`` for a CUDA
tensor or raises; the other leaves, and CPU tensors, take the plain
version with the same formula. Unlike the JAX function, which returns new
trees, this one **updates w, m and v in place** and returns the new count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "adam"
MIN_KERNEL_ELEMS = 1 << 21


def adam_scalars(count: int, lr: float, b1: float, b2: float) -> Tuple[float, float]:
    """``(s1, s2)`` for step ``count`` (1-based), in f32 as the JAX package
    computes them."""
    t = np.float32(count)
    s1 = np.float32(lr) / (np.float32(1.0) - np.float32(b1) ** t)
    s2 = np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t)
    return float(s1), float(s2)


@torch.no_grad()
def adam_update_ref_(g: torch.Tensor, w: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                     s1: float, s2: float, b1: float, b2: float, eps: float) -> None:
    """Plain version of one leaf's update, in place."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * (g * g)
    w.copy_(w - (s1 * m2) / (torch.sqrt(v2 * s2) + eps))
    m.copy_(m2)
    v.copy_(v2)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    fn = lib.adam_update_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_float] * 7
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(g, w, m, v) -> None:
    for name, t in (("g", g), ("w", w), ("m", m), ("v", v)):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, w {tuple(w.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if w.numel() < 1:
        raise ValueError("w is empty")


@torch.no_grad()
def adam_update_(g: torch.Tensor, w: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                 s1: float, s2: float, b1: float, b2: float, eps: float) -> None:
    """One leaf's update, in place: a CPU tensor takes ``adam_update_ref_``;
    a CUDA tensor launches the kernel, or raises."""
    if w.device.type == "cpu":
        adam_update_ref_(g, w, m, v, s1=s1, s2=s2, b1=b1, b2=b2, eps=eps)
        return
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    _check_cuda_args(g, w, m, v)
    fn = _library().adam_update_f32
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(g.data_ptr(), w.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel(),
                 b1, 1.0 - b1, b2, 1.0 - b2, s1, s2, eps, sms, stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: cudaError {err}")
    adam_update_.launches += 1


# Kernel launches since the last reset; the plain version does not count.
adam_update_.launches = 0


def fused_adam_tree_update(
    grads: Dict[str, torch.Tensor],
    count: int,
    mu: Dict[str, torch.Tensor],
    nu: Dict[str, torch.Tensor],
    params: Dict[str, torch.Tensor],
    *,
    lr: float,
    b1: float,
    b2: float,
    eps: float = 1e-8,
    min_kernel_elems: int = MIN_KERNEL_ELEMS,
) -> int:
    """One Adam step over every leaf of ``params``; updates ``params``,
    ``mu`` and ``nu`` in place and returns ``count + 1``."""
    count2 = count + 1
    s1, s2 = adam_scalars(count2, lr, b1, b2)
    coeffs = dict(s1=s1, s2=s2, b1=b1, b2=b2, eps=eps)
    for name, w in params.items():
        g, m, v = grads[name], mu[name], nu[name]
        if w.dim() == 2 and w.numel() >= min_kernel_elems:
            adam_update_(g, w, m, v, **coeffs)
        else:
            adam_update_ref_(g, w, m, v, **coeffs)
    return count2
