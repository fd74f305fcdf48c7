"""Plain PyTorch emulation of the exact three-pass TF32 product of
``csrc/tf32x3.cuh``, the tensor-core engine of both PointNet kernels.

The CPU tests use it to show why the kernels' tolerances need no loosening;
no main path calls it (on the CPU the kernel wrappers compute their plain
f32 versions).

- ``tf32_round`` rounds f32 to TF32 (1 sign, 8 exponent and 10 explicit
  mantissa bits, kept in an f32) as ``cvt.rna.tf32.f32`` does: to nearest,
  ties away from zero, on the bit pattern. Finite inputs only.
- ``split_tf32``: ``hi = tf32(x)``, ``lo = tf32(x − hi)``; ``x − hi`` is
  exact in f32 and ``|x − hi − lo| ≤ 2⁻²²·|x|``.
- ``matmul_3xtf32``: ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi`` with f32
  accumulation, the small terms first, in the kernel's order of passes.
  A product of two TF32 values has at most 22 significant bits, so each
  pass's products are exact in f32 and only the sums round, as in the
  tensor cores; the sum order within a pass is the CPU's, not the card's.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DROP = 13  # f32 mantissa bits that TF32 drops: 23 - 10


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round finite f32 values to TF32, to nearest with ties away from zero."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + (1 << (_DROP - 1))) & ~((1 << _DROP) - 1)
    out = sign | mag
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x → (hi, lo)``, both TF32 values in f32."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' three-pass product of f32 ``a (M, K)`` and ``b (K, N)``."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    acc = torch.matmul(a_lo, b_hi)
    acc = acc + torch.matmul(a_hi, b_lo)
    return acc + torch.matmul(a_hi, b_hi)


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bound on ``|matmul_3xtf32(a, b) − a @ b|`` (exact product), per
    output: ``(3·2⁻²² + (K + 2)·2⁻²⁴)·(|a| @ |b|)``. The first term is the
    dropped ``a_lo·b_lo`` and the two splits' remainders, each at most
    2⁻²² of ``|a||b|``; the second is f32 accumulation over the K products
    of each pass and the two additions of the passes."""
    k = a.shape[-1]
    scale = torch.matmul(a.double().abs(), b.double().abs())
    return (3 * 2.0 ** -22 + (k + 2) * 2.0 ** -24) * scale
