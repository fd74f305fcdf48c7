"""The P4Transformer blocks' dense products (``ops/p4t_linear.py``) on the
CPU: the op is ``F.linear`` there, bit for bit with its autograd; on the
card it refuses with words what its kernels do not take; the weight
gradient's token slices; and the three-pass TF32 arithmetic the kernels
perform (``ops/tf32x3.py``'s emulation) within ``error_bound`` of f64 for
the forward, the input gradient and the split-K weight gradient. No JAX."""

import pytest
import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_linear as pl
from opensetgaitrecognition_pcaa_tpu_torch.ops.tf32x3 import error_bound, matmul_3xtf32


def _inputs(rows, in_, out, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, in_), generator=gen, dtype=dtype)
    w = (2 * torch.rand((out, in_), generator=gen, dtype=dtype) - 1) / in_ ** 0.5
    b = (2 * torch.rand((out,), generator=gen, dtype=dtype) - 1) / in_ ** 0.5
    dy = torch.randn((rows, out), generator=gen, dtype=dtype)
    return x, w, b, dy


@pytest.mark.parametrize("with_bias", [True, False])
def test_cpu_path_is_f_linear_and_its_autograd(with_bias):
    x, w, b, dy = _inputs(45, 12, 20)
    x = x.reshape(3, 15, 12)
    dy = dy.reshape(3, 15, 20)
    b = b if with_bias else None
    leaves = [t.clone().requires_grad_() for t in (x, w) + ((b,) if with_bias else ())]
    twins = [t.clone().requires_grad_() for t in leaves]
    pl.p4t_linear.launches = 0
    got = pl.p4t_linear(*leaves[:2], leaves[2] if with_bias else None)
    want = F.linear(*twins[:2], twins[2] if with_bias else None)
    assert torch.equal(got, want)
    for a, c in zip(torch.autograd.grad(got, leaves, dy), torch.autograd.grad(want, twins, dy)):
        assert torch.equal(a, c)
    assert pl.p4t_linear.launches == 0  # the CPU's F.linear is no launch


def _x_w_b():
    x, w, b, _ = _inputs(10, 8, 12)
    return x, w, b


@pytest.mark.parametrize("case,words", [
    ("in_not_4", "multiples of 4"),
    ("out_not_4", "multiples of 4"),
    ("float64", "float32 only"),
    ("bias_float64", "float32 only"),
    ("not_contiguous", "contiguous"),
    ("bias_shape", "bias has shape"),
    ("x_width", "does not end in"),
    ("no_rows", "no rows"),
])
def test_card_refuses_with_words(case, words):
    """``check_args`` is what the op runs on a CUDA tensor before any
    launch; the CPU tensors here stand in for the card's."""
    x, w, b = _x_w_b()
    if case == "in_not_4":
        x, w = x[:, :6].contiguous(), w[:, :6].contiguous()
    elif case == "out_not_4":
        w, b = w[:10].contiguous(), b[:10].contiguous()
    elif case == "float64":
        x, w, b = x.double(), w.double(), b.double()
    elif case == "bias_float64":
        b = b.double()
    elif case == "not_contiguous":
        x = torch.cat([x, x], 1)[:, ::2]
    elif case == "bias_shape":
        b = b[:8]
    elif case == "x_width":
        x = torch.cat([x, x], 1)
    elif case == "no_rows":
        x = x[:0]
    with pytest.raises(ValueError, match=words):
        pl.check_args(x, w, b)


def test_card_arguments_pass_the_check():
    x, w, b = _x_w_b()
    pl.check_args(x.reshape(2, 5, 8), w, b)
    pl.check_args(x, w, None)


def test_other_devices_have_no_kernel():
    x, w, b = (t.to("meta") for t in _x_w_b())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pl.p4t_linear(x, w, b)


@pytest.mark.parametrize("out,in_,rows,splits", [
    (3072, 1024, 18_000, 2),  # to_qkv: 192 tiles, 384 items, 3 waves of 132
    (1024, 1024, 18_000, 2),  # to_out: 64 tiles, 128 items, one wave
    (2048, 1024, 18_000, 1),  # ff1: 128 tiles, one wave
    (1024, 2048, 18_000, 1),  # ff2
    (1024, 1024, 40, 2),      # two token stages: at most two slices
    (4, 4, 1, 1),
])
def test_weight_gradient_slices(out, in_, rows, splits):
    assert pl.wgrad_splits(out, in_, rows, 132) == splits


def _slices(rows, splits):
    stages = -(-rows // pl.TILE_K)
    edges = [s * stages // splits * pl.TILE_K for s in range(splits)] + [rows]
    return [(min(a, rows), min(b, rows)) for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("product", ["forward", "input_grad", "weight_grad"])
@pytest.mark.parametrize("rows,in_,out", [(300, 64, 96), (75, 128, 32), (1, 16, 8)])
def test_three_pass_products_within_error_bound(product, rows, in_, out):
    """The kernels' arithmetic: every product ``a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi`` into f32; the weight gradient summed over token slices of
    whole 32-token stages in slice order (``wgrad_splits`` at 132 SMs), the
    bias gradient likewise; each within ``error_bound`` of the f64 product
    over the whole K (a slice's sum is bounded by the whole's)."""
    x, w, b, dy = _inputs(rows, in_, out, seed=rows)
    if product == "forward":
        a, m = x, w.t()
        got = matmul_3xtf32(a, m) + b
        want = a.double() @ m.double() + b.double()
        slack = 2.0 ** -24 * want.abs()  # the bias add rounds once more
    elif product == "input_grad":
        a, m = dy, w
        got = matmul_3xtf32(a, m)
        want = a.double() @ m.double()
        slack = 0
    else:
        a, m = dy.t(), x
        splits = pl.wgrad_splits(out, in_, rows, 132)
        got = torch.zeros((out, in_))
        db = torch.zeros((out,))
        for lo, hi in _slices(rows, splits):
            got = got + matmul_3xtf32(dy[lo:hi].t(), x[lo:hi])
            db = db + dy[lo:hi].sum(0)
        want = a.double() @ m.double()
        slack = 0
        db_want = dy.double().sum(0)
        assert ((db.double() - db_want).abs()
                <= (rows + splits) * 2.0 ** -24 * dy.double().abs().sum(0)).all()
    err = (got.double() - want).abs()
    assert (err <= error_bound(a, m) + slack).all(), float(err.max())
