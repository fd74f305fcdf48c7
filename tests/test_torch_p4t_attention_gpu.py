"""The P4Transformer blocks' attention (``csrc/p4t_attention.cu``) on the
card, at the cell's shape (16 crops x 1,125 tokens, 8 heads of 128) and at
ragged token counts against the 32-token tiles and the 64- and 128-row
blocks (1, 63, 64, 65, 200, 1,125):

- the output, each query row's log-sum-exp and the three gradients against
  f64, each largest error within ``F32_ERROR_MULTIPLE`` times plain f32
  attention's (``F.scaled_dot_product_attention`` on the math backend) on
  the same inputs, a limit that the same attention in single-pass TF32
  (the math backend with TF32 allowed, the control) must exceed from 200
  tokens on, so that the check can fail a kernel that lost precision;
- each bitwise equal across two calls (fixed-order sums, no atomics);
- the tokens past n get no weight: a crop's outputs do not change with
  what lies after it in memory;
- a ``Block``'s forward and backward through ``autograd`` against the same
  block on the CPU, and the launch counter's rise for it.

The tests need a CUDA card and skip themselves elsewhere. This file
imports no JAX, so that on the card it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_p4t_attention_gpu.py``.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.models import p4t
from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_attention as pa

DH = 128
# the control's products run in TF32 from this many tokens on: below, cuBLAS
# takes kernels off the tensor cores for the tiny products, whose errors
# stay f32's (at n = 1 and 63 the control's output read f32's, on the card)
CONTROL_TOKENS = 200


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, heads, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * heads * DH), generator=gen, device="cuda")
    g = torch.randn((b, n, heads * DH), generator=gen, device="cuda")
    return qkv, g


def _plain(qkv, g, heads, tf32=False):
    """Attention on the math backend (f32, or single-pass TF32: the
    control): (out, lse, dqkv)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        x = qkv.detach().clone().requires_grad_()
        with sdpa_kernel(SDPBackend.MATH):
            out = pa.attention_ref(x, heads, DH)
        (grad,) = torch.autograd.grad(out, x, g)
        b, n, _ = qkv.shape
        q, k, _ = qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4).unbind(0)
        lse = torch.logsumexp(q @ k.transpose(-1, -2) / math.sqrt(DH), -1)
        return out.detach(), lse, grad
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _exact(qkv, g, heads):
    b, n, _ = qkv.shape
    x = qkv.double().requires_grad_()
    q, k, v = x.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4).unbind(0)
    s = q @ k.transpose(-1, -2) / math.sqrt(DH)
    out = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(b, n, heads * DH)
    (grad,) = torch.autograd.grad(out, x, g.double())
    return out.detach(), torch.logsumexp(s, -1).detach(), grad


def _parts(out, lse, dqkv, inner):
    return {"out": out, "lse": lse, "dq": dqkv[..., :inner], "dk": dqkv[..., inner:2 * inner],
            "dv": dqkv[..., 2 * inner:]}


def _check(b, n, heads, seed):
    qkv, g = _inputs(b, n, heads, seed)
    out, lse = pa.forward(qkv, heads, DH)
    dqkv = pa.backward(qkv, out, lse, g, heads, DH)
    out2, lse2 = pa.forward(qkv, heads, DH)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dqkv, pa.backward(qkv, out, lse, g, heads, DH))
    inner = heads * DH
    mine = _parts(out, lse, dqkv, inner)
    want = _parts(*_exact(qkv, g, heads), inner)
    plain = _parts(*_plain(qkv, g, heads), inner)
    control = _parts(*_plain(qkv, g, heads, tf32=True), inner)
    for name, multiple in pa.F32_ERROR_MULTIPLE.items():
        err, f32, tf32 = (float((t[name].double() - want[name]).abs().max())
                          for t in (mine, plain, control))
        # at least one rounding of the output's scale: at n = 1 f32's own
        # softmax is exact and O = V, and dQ and dK are 0 (then the scale of
        # the operands' products)
        scale = float(want[name].abs().max()) or float(qkv.abs().max() * g.abs().max())
        f32 = max(f32, 2.0 ** -24 * scale)
        limit = multiple * f32
        print(f"({b}, {n}, {heads}) {name}: largest error {err:.3e}, f32 {f32:.3e} "
              f"(x{err / f32:.2f}), single-pass TF32 {tf32:.3e}; limit {limit:.3e}")
        assert err <= limit, (name, err, f32)
        if n >= CONTROL_TOKENS:
            assert tf32 > limit, (name, tf32, f32)


@pytest.mark.gpu
def test_against_f64_at_the_cells_shape():
    _card()
    _check(16, 1125, 8, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 1125])
def test_against_f64_at_ragged_lengths(n):
    _card()
    _check(2, n, 2, seed=n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [33, 1125])
def test_tokens_past_n_get_no_weight(n):
    """Crop 0 alone, and crop 0 followed in memory by another crop (the rows
    a 2-D read past n would take): the same bits, forward and backward."""
    _card()
    qkv, g = _inputs(2, n, 2, seed=7)
    out, lse = pa.forward(qkv, 2, DH)
    dqkv = pa.backward(qkv, out, lse, g, 2, DH)
    alone, g0 = qkv[:1].contiguous(), g[:1].contiguous()
    out0, lse0 = pa.forward(alone, 2, DH)
    assert torch.equal(out0, out[:1]) and torch.equal(lse0, lse[:1])
    assert torch.equal(pa.backward(alone, out0, lse0, g0, 2, DH), dqkv[:1])
    qkv[1] = 1e4  # what follows crop 0 in memory
    out1, lse1 = pa.forward(qkv, 2, DH)
    assert torch.equal(out1[:1], out[:1]) and torch.equal(lse1[:1], lse[:1])


@pytest.mark.gpu
def test_block_through_the_kernels_against_the_cpu():
    """A small block (2 heads of 128) on 2 crops of 200 tokens: the card's
    forward and every gradient against the same block on the CPU, where
    attention is SDPA and the dense products F.linear; 4 attention launches
    (1 forward, 3 backward)."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    block = p4t.Block(256, 2, DH, 512, gen)
    x = torch.randn((2, 200, 256), generator=gen).requires_grad_()
    g = torch.randn((2, 200, 256), generator=gen)
    want = block(x)
    want_grads = torch.autograd.grad(want, [x] + list(block.parameters()), g)

    block_card = block.to(dev)
    x_card = x.detach().to(dev).requires_grad_()
    pa.p4t_attention.launches = 0
    got = block_card(x_card)
    got_grads = torch.autograd.grad(got, [x_card] + list(block_card.parameters()), g.to(dev))
    assert pa.p4t_attention.launches == 4
    for a, c in zip([got] + list(got_grads), [want] + list(want_grads)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-4 * float(c.abs().max()))


@pytest.mark.gpu
def test_refuses_on_the_card_with_words():
    dev = _card()
    with pytest.raises(ValueError, match="take dim_head in"):
        pa.p4t_attention(torch.randn((1, 4, 3 * 64), device=dev), 1, 64)
    with pytest.raises(ValueError, match="float32 only"):
        pa.p4t_attention(torch.randn((1, 4, 3 * 128), device=dev, dtype=torch.float64), 1, 128)
