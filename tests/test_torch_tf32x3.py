"""The arithmetic of the PointNet kernels' exact three-pass TF32 product,
emulated on the CPU (``ops/tf32x3.py``), at the PointNet widths.

This is the written argument for the kernels' card tolerances (kernel
against plain at rtol 1e-4, atol 1e-4): the split keeps 22 of f32's 24
mantissa bits, and the three-pass product lies within 1e-5 of the plain f32
product, measured relative to ``|a|·|b|``, the error scale of a dot
product.
"""

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops import tf32x3

WIDTHS = [(4, 512), (512, 512), (512, 1024), (1024, 1024)]  # (K, N) of the four layers
IDS = ["k4", "k512_n512", "k512_n1024", "k1024"]


def _operands(k: int, n: int, rows: int = 256, seed: int = 0):
    """Activation-like a (rows, K) and weight-like b (K, N), with values
    spread over several binades."""
    rng = np.random.default_rng(seed + k + n)
    a = (rng.normal(size=(rows, k)) * np.exp(rng.uniform(-4, 2, (rows, k)))).astype(np.float32)
    b = (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize(
    "x,want",
    [
        (1 + 2.0 ** -11, 1 + 2.0 ** -10),  # a tie rounds away from zero
        (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
        (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # below the tie: down
        (1 + 5 * 2.0 ** -11, 1 + 3 * 2.0 ** -10),  # a tie above an even mantissa: away, not to even
        (2 - 2.0 ** -23, 2.0),  # carries into the exponent
        (0.0, 0.0),
    ],
    ids=["tie_up", "tie_negative", "below_tie", "tie_above_even", "carry", "zero"],
)
def test_tf32_round_is_round_to_nearest_ties_away(x, want):
    got = tf32x3.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == np.float32(want)


@pytest.mark.parametrize("k,n", WIDTHS, ids=IDS)
def test_split_keeps_22_bits(k, n):
    a, b = _operands(k, n)
    for x in (a, b):
        hi, lo = tf32x3.split_tf32(x)
        # hi and lo keep 10 explicit mantissa bits: the low 13 are zero
        assert not (_bits(hi) & 0x1FFF).any()
        assert not (_bits(lo) & 0x1FFF).any()
        # x - hi is exact in f32, and the remainder after lo is below 2^-22 |x|
        x64 = x.double()
        assert torch.equal((x - hi).double(), x64 - hi.double())
        rest = (x64 - hi.double() - lo.double()).abs()
        assert bool((rest <= 2.0 ** -22 * x64.abs()).all())


@pytest.mark.parametrize("k,n", WIDTHS, ids=IDS)
def test_three_pass_product_is_f32_exact(k, n):
    a, b = _operands(k, n)
    got = tf32x3.matmul_3xtf32(a, b).double()
    exact = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    # within the stated bound of the f64 product
    assert bool(((got - exact).abs() <= tf32x3.error_bound(a, b)).all())
    # within 1e-5 of the plain f32 product, relative to |a|·|b|
    plain = torch.matmul(a, b).double()
    gap = float(((got - plain).abs() / scale).max())
    assert gap <= 1e-5, gap
    # and a single TF32 pass would not be: the split is what keeps f32
    one_pass = torch.matmul(tf32x3.tf32_round(a), tf32x3.tf32_round(b)).double()
    assert float(((one_pass - exact).abs() / scale).max()) > 1e-4
