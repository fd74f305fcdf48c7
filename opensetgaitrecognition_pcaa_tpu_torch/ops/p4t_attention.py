"""The P4Transformer blocks' attention (``models/p4t.py::Block``):
``softmax(q·kᵀ/√dh)·v`` over a crop's tokens, every head, and its gradient,
as one ``torch.autograd.Function`` over the hand-written Hopper kernels of
``csrc/p4t_attention.cu``.

No TPU kernel is ported here: the JAX package has no P4Transformer. On the
card the products run on the tensor cores in the exact three-pass TF32 mode
of the port's other kernels (``ops/tf32x3.py`` emulates it): a
flash-attention forward that writes O and each query row's log-sum-exp, and
a flash-attention-2 backward (D = rowsum(dO ∘ O), then dK and dV a key tile
a block, then dQ a query tile a block) that writes the gradient of ``qkv``
as one tensor. Neither holds the ``(B, heads, n, n)`` scores, and every
output is a fixed-order sum: two calls on the same inputs give the same
bits.

``p4t_attention`` takes ``to_qkv``'s output as it lies, ``qkv (B, n,
3·heads·dim_head)`` (q, k, v in that order, heads of ``dim_head``), and
returns ``(B, n, heads·dim_head)``, ready for ``to_out``. A CPU tensor takes
the view, ``F.scaled_dot_product_attention`` and the reshape, the numbers
the CPU tests have always seen. A CUDA tensor launches the kernels or
raises with words (``check_args``): f32, contiguous, ``dim_head`` in
``DIM_HEADS``, at least one token; there is no fallback to the library. The
wrapper counts its launches (``p4t_attention.launches``, and the program
counter of the same name, ``utils/profiling.py::count``): a forward is 1, a
backward 3.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count

_KERNEL = "p4t_attention"
DIM_HEADS = (128,)  # the head widths the kernels are built for
# The largest error of each output against f64 that the card checks allow,
# as a multiple of plain f32 attention's largest (the math backend of
# F.scaled_dot_product_attention) on the same inputs: the kernels read 1.0
# to 7.4 times f32's on the card (the most, dQ at 200 tokens: its scores and
# dO·Vᵀ are summed over dh in the tensor cores' f32, which truncates at
# every wgmma, and dP − D cancels), single-pass TF32 280 to 1,450 times from
# 200 tokens on, which fails each.
F32_ERROR_MULTIPLE = {"out": 16.0, "lse": 16.0, "dq": 16.0, "dk": 16.0, "dv": 16.0}


def check_args(qkv: torch.Tensor, heads: int, dim_head: int) -> None:
    """Raise ``ValueError`` unless the kernels take these arguments (the
    device aside)."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, n, 3·heads·dim_head), got shape {tuple(qkv.shape)}")
    b, n, width = qkv.shape
    if heads < 1 or width != 3 * heads * dim_head:
        raise ValueError(f"qkv's last dimension {width} is not 3 x heads {heads} x dim_head "
                         f"{dim_head}")
    if dim_head not in DIM_HEADS:
        raise ValueError(f"the p4t_attention kernels take dim_head in {DIM_HEADS}, got "
                         f"{dim_head}")
    if b == 0 or n == 0:
        raise ValueError(f"qkv has no tokens: {tuple(qkv.shape)}")
    if b * n >= 2**31:
        raise ValueError(f"qkv has {b * n} rows; the kernels take fewer than 2^31")
    if b * heads > 65535:
        raise ValueError(f"{b} crops x {heads} heads; the kernels take at most 65535")
    if qkv.dtype != torch.float32:
        raise ValueError(f"the p4t_attention kernels take float32 only (3xTF32 products into "
                         f"f32); qkv is {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned (the TMA's base)")


def attention_ref(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """The plain version: q, k, v as views of ``qkv``, SDPA, heads merged."""
    b, n, _ = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4).unbind(0)
    a = F.scaled_dot_product_attention(q, k, v)                     # (B, heads, n, dh)
    return a.transpose(1, 2).reshape(b, n, heads * dim_head)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.p4t_attention_forward.argtypes = [p, p, p, i, i, i, i, p]
    lib.p4t_attention_backward.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    for fn in (lib.p4t_attention_forward, lib.p4t_attention_backward):
        fn.restype = ctypes.c_int
    return lib


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"p4t_attention {what} kernel launch failed: cudaError {err}")


def _launched(k: int) -> None:
    p4t_attention.launches += k
    count("p4t_attention.launches", k)


def forward(qkv: torch.Tensor, heads: int, dim_head: int):
    """``(O (B, n, heads·dim_head), lse (B, heads, n))`` on the card: the
    output and each query row's log-sum-exp of its scaled scores; one
    launch."""
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * dim_head), dtype=torch.float32, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        _raise(_library().p4t_attention_forward(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, heads, dim_head,
            torch.cuda.current_stream(qkv.device).cuda_stream), "forward")
    _launched(1)
    return out, lse


def backward(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor,
             heads: int, dim_head: int) -> torch.Tensor:
    """The gradient of ``qkv`` (B, n, 3·heads·dim_head) from the forward's
    ``out`` and ``lse`` and the output's gradient; three launches."""
    b, n, _ = qkv.shape
    grad = grad.contiguous()
    if grad.data_ptr() % 16:  # a view at an odd offset: the TMA needs its base aligned
        grad = grad.clone()
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        _raise(_library().p4t_attention_backward(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), grad.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), b, n, heads, dim_head,
            torch.cuda.current_stream(qkv.device).cuda_stream), "backward")
    _launched(3)
    return dqkv


class P4TAttention(torch.autograd.Function):
    """``qkv (B, n, 3·heads·dim_head) → (B, n, heads·dim_head)`` on the
    card, and the gradient of ``qkv``."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head):
        out, lse = forward(qkv, heads, dim_head)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.dim_head = heads, dim_head
        return out

    @staticmethod
    def backward(ctx, grad):
        qkv, out, lse = ctx.saved_tensors
        return backward(qkv, out, lse, grad, ctx.heads, ctx.dim_head), None, None


def p4t_attention(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """Multi-head attention of ``qkv``: SDPA on the CPU, the kernels on the
    card (the module docstring)."""
    if qkv.device.type == "cpu":
        return attention_ref(qkv, heads, dim_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    check_args(qkv, heads, dim_head)
    return P4TAttention.apply(qkv, heads, dim_head)


# Kernel launches since the last reset (forwards and backwards); the CPU's
# SDPA does not count.
p4t_attention.launches = 0
