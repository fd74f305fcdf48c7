"""The P4Transformer blocks' dense products (``csrc/p4t_linear.cu``) on the
card, at the cell's shapes: 18,000 rows (16 crops × 1,125 tokens) and one
crop's 1,125 (ragged against the 256-row tiles and 32-token stages), (in,
out) of ``to_qkv``, ``to_out``, ``ff1`` and ``ff2``:

- the forward, the input gradient and the weight gradient against f64, each
  within ``ops/tf32x3.py::error_bound``, the bound of the three-pass mode,
  and its largest error within ``CUBLAS_ERROR_MULTIPLE`` times cuBLAS f32's
  on the same inputs, a limit that the same product in single-pass TF32
  (cuBLAS with TF32 allowed, the control) must exceed, so that the check
  can fail a product that lost precision; the bias gradient (the column sum
  of dY) within the bound of its sequential sums;
- each bitwise equal across two calls (fixed-order sums, no atomics);
- a ``Block``'s forward and backward through ``autograd`` against the same
  block through ``F.linear``, and the launch counter's rise for it.

The tests need a CUDA card and skip themselves elsewhere. This file
imports no JAX, so that on the card it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_p4t_linear_gpu.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.models import p4t
from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_linear as pl
from opensetgaitrecognition_pcaa_tpu_torch.ops.tf32x3 import error_bound

SHAPES = [(1024, 3072, False), (1024, 1024, True), (1024, 2048, True), (2048, 1024, True)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rows, in_, out, with_bias, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, in_), generator=gen, device="cuda")
    w = (2 * torch.rand((out, in_), generator=gen, device="cuda") - 1) / in_ ** 0.5
    b = (2 * torch.rand((out,), generator=gen, device="cuda") - 1) / in_ ** 0.5 \
        if with_bias else None
    dy = torch.randn((rows, out), generator=gen, device="cuda") / out ** 0.5
    return x, w, b, dy


def _tf32(fn):
    """``fn()`` with cuBLAS allowed single-pass TF32: the control."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _within(got, want, a, b, cublas, what, slack=0):
    """``got`` within the three-pass mode's bound of the exact ``want = a @
    b`` and within its product's multiple of cuBLAS f32's largest error,
    ``cublas()``, which single-pass TF32 exceeds; the three largest errors
    are printed."""
    err = (got.double() - want).abs()
    assert (err <= error_bound(a, b) + slack).all(), what
    mine, plain, control = (float(e) for e in (
        err.max(), (cublas().double() - want).abs().max(),
        (_tf32(cublas).double() - want).abs().max()))
    limit = pl.CUBLAS_ERROR_MULTIPLE[what] * plain
    print(f"{what}: largest error {mine:.3e}, cuBLAS f32 {plain:.3e}, single-pass TF32 "
          f"{control:.3e}; limit {limit:.3e}")
    assert mine <= limit, (what, mine, plain)
    assert control > limit, (what, control, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [18_000, 1_125])
@pytest.mark.parametrize("in_,out,with_bias", SHAPES)
def test_products_against_f64_and_cublas(rows, in_, out, with_bias):
    _card()
    x, w, b, dy = _inputs(rows, in_, out, with_bias, seed=rows + out)
    x64, w64, dy64 = x.double(), w.double(), dy.double()

    y = pl.forward_product(x, w, b)
    want = x64 @ w64.t() + (b.double() if with_bias else 0)
    _within(y, want, x, w.t(), lambda: F.linear(x, w, b), "forward", 2.0 ** -24 * want.abs())
    assert torch.equal(y, pl.forward_product(x, w, b))

    dx = pl.input_grad(dy, w)
    want = dy64 @ w64
    _within(dx, want, dy, w, lambda: torch.mm(dy, w), "input_grad")
    assert torch.equal(dx, pl.input_grad(dy, w))

    dw, db = pl.weight_grad(dy, x, with_bias)
    want = dy64.t() @ x64
    _within(dw, want, dy.t(), x, lambda: torch.mm(dy.t(), x), "weight_grad")
    dw2, db2 = pl.weight_grad(dy, x, with_bias)
    assert torch.equal(dw, dw2)
    if with_bias:
        # a thread's sums: 8 values a stage, the stages of its slice, 2
        # butterfly steps, then the slices in order
        stages = -(-rows // pl.TILE_K)
        adds = 8 + stages + 2 + pl.MAX_SPLITS
        bound = adds * 2.0 ** -24 * dy64.abs().sum(0)
        assert ((db.double() - dy64.sum(0)).abs() <= bound).all()
        assert torch.equal(db, db2)
    else:
        assert db is None and db2 is None


@pytest.mark.gpu
def test_block_forward_and_backward_through_the_kernels():
    """One block at the published widths on one crop's 1,125 tokens: the
    kernels against the same block through F.linear (cuBLAS f32), output and
    every gradient, and 24 launches: 4 products, each 2 forward and 4
    backward."""
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    block = p4t.Block(1024, 8, 128, 2048, gen).to(dev)
    x = torch.randn((1, 1125, 1024), generator=gen).to(dev).requires_grad_()
    g = torch.randn((1, 1125, 1024), generator=gen).to(dev)
    params = [x] + list(block.parameters())

    pl.p4t_linear.launches = 0
    got = block(x)
    got_grads = torch.autograd.grad(got, params, g)
    assert pl.p4t_linear.launches == 24

    real = p4t.p4t_linear
    p4t.p4t_linear = F.linear
    try:
        want = block(x)
        want_grads = torch.autograd.grad(want, params, g)
    finally:
        p4t.p4t_linear = real
    # the products' largest errors are about 1e-5 of their largest values
    for a, c in zip([got] + list(got_grads), [want] + list(want_grads)):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4 * float(c.abs().max()))


@pytest.mark.gpu
def test_refuses_on_the_card_with_words():
    dev = _card()
    x = torch.randn((10, 6), device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        pl.p4t_linear(x, torch.randn((8, 6), device=dev))
    with pytest.raises(ValueError, match="float32 only"):
        pl.p4t_linear(torch.randn((10, 8), device=dev, dtype=torch.float64),
                      torch.randn((8, 8), device=dev, dtype=torch.float64))
