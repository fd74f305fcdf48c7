"""One-pass Adam over a parameter dict: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/adam_kernel.py``
(``fused_adam_tree_update``). Per leaf, with ``t = count + 1``,
``s1 = lr / (1 − b1^t)`` and ``s2 = 1 / (1 − b2^t)`` computed in f32:

    m' = b1·m + (1 − b1)·g
    v' = b2·v + (1 − b2)·g²
    w' = w − (s1·m') / (√(v'·s2) + eps)

g and w are f32; m and v are each f32 or bf16 (``adam_lowmem``'s storage,
as the JAX function keeps it leaf by leaf): the arithmetic is f32, a bf16
moment is upcast when read, and m' and v' are rounded to bf16 (nearest
even) only when stored. The kernel has four variants: f32 moments, m
bf16, m and v bf16, v bf16 (JAX ``build_pcaa``'s moments at f32 compute
with ``BF16_ADAM_NU``). The two layouts of bf16 compute, m bf16 and m and v
bf16, also take ``w16``: a bf16 tensor shaped like w into which the kernel
writes the updated weight rounded to bf16 (``__float2bfloat16_rn``, nearest
even), the decoder's weight cache of ``Config.BF16_WEIGHT_CACHE`` (JAX
``train/pcaa.py::_cache_tree`` of the new parameters, which XLA fuses into
the update).

2-D leaves of at least ``min_kernel_elems`` elements (2²¹, the JAX
package's own rule: the four big decoder matrices at the published widths;
counted on the leaf's global shape, so that a model rank's shard of such a
leaf under tensor parallelism takes the kernel too) go through
``adam_update_``, which launches ``csrc/adam.cu`` for a CUDA
tensor or raises; the other leaves, and CPU tensors, take the plain
version with the same formula (which writes a leaf's copy with
``.copy_``, a cast to bf16). Unlike the JAX function, which returns new
trees, this one **updates w, m and v in place** and returns the new count.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "adam"
MIN_KERNEL_ELEMS = 1 << 21
_F32, _BF16 = torch.float32, torch.bfloat16
# (m dtype, v dtype) -> the kernel's entry point and its launch counter
_VARIANTS = {(_F32, _F32): ("adam_update_f32", "launches"),
             (_BF16, _F32): ("adam_update_m16", "launches_m16"),
             (_BF16, _BF16): ("adam_update_mv16", "launches_mv16"),
             (_F32, _BF16): ("adam_update_v16", "launches_v16")}
# the same with the bf16 copy of w: the layouts of bf16 compute
_COPY_VARIANTS = {(_BF16, _F32): ("adam_update_m16_w16", "launches_m16_w16"),
                  (_BF16, _BF16): ("adam_update_mv16_w16", "launches_mv16_w16")}


def adam_scalars(count: int, lr: float, b1: float, b2: float) -> Tuple[float, float]:
    """``(s1, s2)`` for step ``count`` (1-based), in f32 as the JAX package
    computes them."""
    t = np.float32(count)
    s1 = np.float32(lr) / (np.float32(1.0) - np.float32(b1) ** t)
    s2 = np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t)
    return float(s1), float(s2)


@torch.no_grad()
def adam_update_ref_(g: torch.Tensor, w: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                     s1: float, s2: float, b1: float, b2: float, eps: float,
                     w16: Optional[torch.Tensor] = None) -> None:
    """Plain version of one leaf's update, in place; bf16 moments are upcast
    and rounded back when stored; ``w16`` (optional) takes the new w
    rounded to bf16."""
    m2 = b1 * m.float() + (1.0 - b1) * g
    v2 = b2 * v.float() + (1.0 - b2) * (g * g)
    w.copy_(w - (s1 * m2) / (torch.sqrt(v2 * s2) + eps))
    m.copy_(m2)
    v.copy_(v2)
    if w16 is not None:
        w16.copy_(w)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    for variants, n_ptr in ((_VARIANTS, 4), (_COPY_VARIANTS, 5)):
        for entry, _ in variants.values():
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong]
                           + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(g, w, m, v, w16=None) -> None:
    variants = _VARIANTS if w16 is None else _COPY_VARIANTS
    if (m.dtype, v.dtype) not in variants:
        raise ValueError(f"no kernel for moments m {m.dtype}, v {v.dtype}"
                         + ("" if w16 is None else " with a bf16 copy of w"))
    tensors = (("g", g), ("w", w), ("m", m), ("v", v))
    if w16 is not None:
        if w16.dtype != _BF16:
            raise ValueError(f"w16 must be bfloat16, got {w16.dtype}")
        tensors += (("w16", w16),)
    for name, t in tensors:
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if name in ("g", "w") and t.dtype != _F32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, w {tuple(w.shape)}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be aligned to 4 of its elements")
    if w.numel() < 1:
        raise ValueError("w is empty")


@torch.no_grad()
def adam_update_(g: torch.Tensor, w: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                 s1: float, s2: float, b1: float, b2: float, eps: float,
                 w16: Optional[torch.Tensor] = None) -> None:
    """One leaf's update, in place: a CPU tensor takes ``adam_update_ref_``;
    a CUDA tensor launches the kernel variant of the moments' dtypes (with
    the bf16 copy of w where ``w16`` is given), or raises."""
    if w.device.type == "cpu":
        adam_update_ref_(g, w, m, v, s1=s1, s2=s2, b1=b1, b2=b2, eps=eps, w16=w16)
        return
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    _check_cuda_args(g, w, m, v, w16)
    entry, counter = (_VARIANTS if w16 is None else _COPY_VARIANTS)[(m.dtype, v.dtype)]
    fn = getattr(_library(), entry)
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    ptrs = [t.data_ptr() for t in (g, w, m, v)] + ([] if w16 is None else [w16.data_ptr()])
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(*ptrs, w.numel(), b1, 1.0 - b1, b2, 1.0 - b2, s1, s2, eps, sms, stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: cudaError {err}")
    setattr(adam_update_, counter, getattr(adam_update_, counter) + 1)
    adam_update_.shapes[tuple(w.shape)] += 1


# Kernel launches since the last reset, per variant (f32 moments; m bf16;
# m and v bf16; v bf16; m bf16 with the copy of w; m and v bf16 with the
# copy), and of all variants per leaf shape; the plain version does not
# count.
adam_update_.launches = 0
adam_update_.launches_m16 = 0
adam_update_.launches_mv16 = 0
adam_update_.launches_v16 = 0
adam_update_.launches_m16_w16 = 0
adam_update_.launches_mv16_w16 = 0
adam_update_.shapes = collections.Counter()


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
    global_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> int:
    """One Adam step over every leaf of ``params``; updates ``params``,
    ``mu`` and ``nu`` in place and returns ``count + 1``. ``global_shapes``
    (by name) are the leaves' shapes before tensor parallelism sharded
    them, which choose kernel or plain; by default the leaves' own.
    ``cache`` (by name, optional) holds bf16 copies of some leaves, which
    take the updated leaf rounded to bf16."""
    count2 = count + 1
    s1, s2 = adam_scalars(count2, lr, b1, b2)
    coeffs = dict(s1=s1, s2=s2, b1=b1, b2=b2, eps=eps)
    cache = cache or {}
    for name, w in params.items():
        g, m, v, w16 = grads[name], mu[name], nu[name], cache.get(name)
        shape = tuple(w.shape) if global_shapes is None else tuple(global_shapes[name])
        if len(shape) == 2 and math.prod(shape) >= min_kernel_elems:
            adam_update_(g, w, m, v, w16=w16, **coeffs)
        else:
            adam_update_ref_(g, w, m, v, w16=w16, **coeffs)
    return count2
