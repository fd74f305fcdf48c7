"""The P4Transformer blocks' dense products (``models/p4t.py::Block``'s
``to_qkv``, ``to_out``, ``ff1``, ``ff2``): ``Y = X·Wᵀ (+ b)`` and its
gradients as one ``torch.autograd.Function`` over the hand-written Hopper
kernels of ``csrc/p4t_linear.cu``.

No TPU kernel is ported here: the JAX package has no P4Transformer. On the
card the three products run on the tensor cores in the exact three-pass
TF32 mode of the PointNet kernels (``ops/tf32x3.py`` emulates it): the
forward ``X·Wᵀ`` and the input gradient ``dY·W`` on the ``wgmma`` engine
``csrc/tf32x3_wgmma.cuh`` (each after one launch that splits ``W``, or
``Wᵀ``, into TF32 hi/lo planes), the weight gradient ``dYᵀ·X`` and the bias
gradient ``Σ dY`` in one split-K kernel over the token axis whose partials a
last launch adds in order. Every output is a fixed-order sum: two calls on
the same inputs give the same bits.

``p4t_linear`` takes ``x (..., in)``, ``weight (out, in)`` and ``bias
(out,)`` or None. A CPU tensor takes ``F.linear`` and its autograd, the
numbers the CPU tests have always seen. A CUDA tensor launches the kernels
or raises with words (``check_args``): f32, contiguous, ``in`` and ``out``
multiples of 4, any number of rows; there is no fallback to cuBLAS. The
wrapper counts its launches (``p4t_linear.launches``): a forward is 2, a
backward 4 where both gradients are taken (the split, the input gradient,
the weight gradient and, where ``wgrad_splits`` gives more than one slice
or there is a bias, the reduction).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "p4t_linear"
TILE_M, TILE_N, TILE_K = 128, 128, 32  # the weight gradient's output tile and token stage
MAX_SPLITS = 4  # token slices of the weight gradient: 3 partials of a weight at most
# The largest error of each product against f64 that the card checks allow,
# as a multiple of cuBLAS f32's largest on the same inputs. The forward and
# input gradient sum K in the tensor cores' f32, which drops low bits at
# every wgmma: up to 32 times cuBLAS's at the cell's shapes. The weight
# gradient's two-level sums stay under cuBLAS's. Single-pass TF32 reads
# 140 to 520 times cuBLAS's and fails each.
CUBLAS_ERROR_MULTIPLE = {"forward": 64.0, "input_grad": 64.0, "weight_grad": 1.0}


def wgrad_splits(out: int, in_: int, rows: int, sms: int) -> int:
    """The token slices of the weight gradient: the count in 1 ..
    ``MAX_SPLITS`` (and at most the token stages) whose work items (output
    tiles × slices) take the fewest waves of ``sms`` blocks per slice of
    work, the smallest on a tie."""
    tiles = -(-out // TILE_M) * -(-in_ // TILE_N)
    stages = -(-rows // TILE_K)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, stages) + 1):
        cost = -(-tiles * s // sms) / s
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def check_args(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the kernels take these arguments (the
    device aside)."""
    if weight.dim() != 2:
        raise ValueError(f"weight must be (out, in), got shape {tuple(weight.shape)}")
    out, in_ = weight.shape
    if x.dim() < 1 or x.shape[-1] != in_:
        raise ValueError(f"x {tuple(x.shape)} does not end in the weight's in = {in_}")
    if in_ < 4 or in_ % 4 or out < 4 or out % 4:
        raise ValueError(f"the p4t_linear kernels take in and out multiples of 4 (the TMA's "
                         f"16-byte rows), got in={in_}, out={out}")
    if x.numel() == 0:
        raise ValueError(f"x has no rows: {tuple(x.shape)}")
    if x.numel() // in_ >= 2**31:
        raise ValueError(f"x has {x.numel() // in_} rows; the kernels take fewer than 2^31")
    if bias is not None and tuple(bias.shape) != (out,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, want ({out},)")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the p4t_linear kernels take float32 only (3xTF32 products "
                             f"into f32); {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the TMA's base)")


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.p4t_linear_split.argtypes = [p, i, i, i, p, p]
    lib.p4t_linear_gemm.argtypes = [p, p, p, p, i, i, i, p]
    lib.p4t_linear_wgrad.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
    for fn in (lib.p4t_linear_split, lib.p4t_linear_gemm, lib.p4t_linear_wgrad):
        fn.restype = ctypes.c_int
    return lib


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"p4t_linear {what} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _product(a: torch.Tensor, weight: torch.Tensor, transpose: bool,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``a (rows, k) @ Wᵀ + bias`` (``transpose`` False: k = in) or ``a @
    W`` (True: k = out): W split into the engine's planes, then the
    product; 2 launches."""
    out, in_ = weight.shape
    n = in_ if transpose else out
    lib = _library()
    planes = torch.empty(2 * weight.numel(), dtype=torch.float32, device=weight.device)
    y = torch.empty((a.shape[0], n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = _stream(a)
        _raise(lib.p4t_linear_split(weight.data_ptr(), out, in_, int(transpose),
                                    planes.data_ptr(), stream), "split")
        _raise(lib.p4t_linear_gemm(a.data_ptr(), planes.data_ptr(),
                                   None if bias is None else bias.data_ptr(), y.data_ptr(),
                                   a.shape[0], a.shape[1], n, stream), "gemm")
    p4t_linear.launches += 2
    return y


def forward_product(x2: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x2 (rows, in) → (rows, out)``: ``x2·Wᵀ (+ bias)`` on the card."""
    return _product(x2, weight, False, bias)


def input_grad(dy2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``dy2 (rows, out) → (rows, in)``: ``dy2·W`` on the card."""
    return _product(dy2, weight, True, None)


def weight_grad(dy2: torch.Tensor, x2: torch.Tensor, with_bias: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dy2ᵀ·x2 (out, in), Σ_rows dy2 (out,) or None)`` on the card: the
    split-K kernel, then, where it has several slices or a bias, their
    reduction in slice order."""
    rows, out = dy2.shape
    in_ = x2.shape[1]
    sms = torch.cuda.get_device_properties(dy2.device).multi_processor_count
    splits = wgrad_splits(out, in_, rows, sms)
    dev = dy2.device
    dw = torch.empty((out, in_), dtype=torch.float32, device=dev)
    partial = torch.empty(((splits - 1) * out * in_,), dtype=torch.float32, device=dev)
    db = torch.empty((out,), dtype=torch.float32, device=dev) if with_bias else None
    db_partial = torch.empty((splits * out,), dtype=torch.float32, device=dev) if with_bias \
        else None
    with torch.cuda.device(dev):
        _raise(_library().p4t_linear_wgrad(
            dy2.data_ptr(), x2.data_ptr(), rows, out, in_, splits, dw.data_ptr(),
            partial.data_ptr() if splits > 1 else None,
            None if db_partial is None else db_partial.data_ptr(),
            None if db is None else db.data_ptr(), _stream(dy2)), "weight gradient")
    p4t_linear.launches += 2 if splits > 1 or with_bias else 1
    return dw, db


class P4TLinear(torch.autograd.Function):
    """``(x (..., in), W (out, in), b (out,) or None) → (..., out)`` on the
    card; gradients for each input that needs one."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        x2 = x.reshape(-1, weight.shape[1])
        y = forward_product(x2, weight, bias)
        ctx.save_for_backward(x, weight)
        ctx.with_bias = bias is not None
        return y.reshape(x.shape[:-1] + (weight.shape[0],))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        dy2 = grad.reshape(-1, weight.shape[0]).contiguous()
        if dy2.data_ptr() % 16:  # a view at an odd offset: the TMA needs its base aligned
            dy2 = dy2.clone()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = input_grad(dy2, weight).reshape(x.shape)
        want_db = ctx.with_bias and ctx.needs_input_grad[2]
        if ctx.needs_input_grad[1] or want_db:
            dw, db = weight_grad(dy2, x.reshape(-1, weight.shape[1]), want_db)
            if not ctx.needs_input_grad[1]:
                dw = None
        return dx, dw, db


def p4t_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x·Wᵀ (+ bias)``: ``F.linear`` on the CPU, the kernels on the card
    (the module docstring)."""
    if x.device.type == "cpu":
        return F.linear(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_args(x, weight, bias)
    return P4TLinear.apply(x, weight, bias)


# Kernel launches since the last reset (forwards and backwards); the CPU's
# F.linear does not count.
p4t_linear.launches = 0
