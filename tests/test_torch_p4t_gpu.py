"""The P4Transformer kernels (``csrc/p4t_group.cu``, ``csrc/p4t_tube.cu``)
against their plain PyTorch versions on the card, at the published sizes
(B 16, T 30, N 150, M 75, K 32, D 1024) on the benchmark's synthetic crops:

- farthest-point sampling and the ball query: the indices bit for bit;
- the tube's forward: the maxima and the argmax bit for bit (each product and
  sum rounded on its own on both sides);
- the tube's weight gradients against autograd through the materialised
  plain tube (every sample's feature, then the max), within f32 rounding of
  sums over 18,000 tokens taken in other orders.

The tests need a CUDA card and skip themselves elsewhere. This file
imports no JAX, so that on the card it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_p4t_gpu.py``.
"""

import numpy as np
import pytest
import torch

from benchmark import traffic
from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_group, p4t_tube

MIX = {"crops": 16, "classes": 6, "frames": [60, 100], "points": [40, 220]}
DIMS = {"NMAX": 150, "NSTEPS": 30, "CROP_STEP": 6}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _crops(seed: int, device) -> torch.Tensor:
    return torch.from_numpy(traffic.crops(MIX, DIMS, seed)[0]).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_grouping_bitwise(seed):
    dev = _card()
    x = _crops(seed, dev)
    frames = x[:, 0::2]
    p4t_group.furthest_point_sample.launches = p4t_group.ball_query.launches = 0
    anchor = p4t_group.furthest_point_sample(frames, 75)
    assert torch.equal(anchor, p4t_group.furthest_point_sample_ref(frames, 75))
    ball = p4t_group.ball_query(x, anchor, 0.7, 32)
    assert torch.equal(ball, p4t_group.ball_query_ref(x, anchor, 0.7, 32, 3, 2, 1))
    assert (p4t_group.furthest_point_sample.launches, p4t_group.ball_query.launches) == (1, 1)


@pytest.mark.gpu
def test_grouping_ragged_and_wide():
    """N not a multiple of 32, a frame wider than 48 KB of shared memory."""
    dev = _card()
    rng = np.random.default_rng(0)
    for n, m, k in ((37, 9, 8), (5000, 40, 32)):
        x = torch.from_numpy(rng.normal(0, 1, (2, 6, n, 4)).astype(np.float32)).to(dev)
        anchor = p4t_group.furthest_point_sample(x[:, 0::2], m)
        assert torch.equal(anchor, p4t_group.furthest_point_sample_ref(x[:, 0::2], m))
        ball = p4t_group.ball_query(x, anchor, 0.7, k)
        assert torch.equal(ball, p4t_group.ball_query_ref(x, anchor, 0.7, k, 3, 2, 1))


def _tube_inputs(seed, dev, crops=16):
    x = _crops(seed, dev)[:crops].contiguous()
    anchor = p4t_group.furthest_point_sample(x[:, 0::2], 75)
    ball = p4t_group.ball_query(x, anchor, 0.7, 32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_d = (torch.rand((1024, 4), generator=gen, device=dev) - 0.5).requires_grad_()
    w_f = (2 * torch.rand((1024, 1), generator=gen, device=dev) - 1).requires_grad_()
    return x, anchor, ball, w_d, w_f


@pytest.mark.gpu
def test_tube_forward_bitwise():
    dev = _card()
    x, anchor, ball, w_d, w_f = _tube_inputs(5, dev)
    w = torch.cat([w_d, w_f], 1).detach().contiguous()
    p4t_tube.tube_embed.launches = 0
    with torch.no_grad():
        out = p4t_tube.tube_embed(x, anchor, ball, w_d, w_f)
    best, arg = p4t_tube.tube_forward_ref(x, anchor, ball, w, 3, 2, 1)
    assert torch.equal(out, best)
    assert p4t_tube.tube_embed.launches == 1
    # the argmax the backward reads: the same weight gradient as the plain one's
    g = torch.randn(out.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    dw = p4t_tube.tube_backward_ref(x, anchor, ball, g, arg, 3, 2, 1)
    got = torch.autograd.grad((p4t_tube.tube_embed(x, anchor, ball, w_d, w_f) * g).sum(),
                              (w_d, w_f))
    torch.testing.assert_close(torch.cat(got, 1), dw, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_tube_weight_gradients_against_materialised_tube():
    dev = _card()
    x, anchor, ball, w_d, w_f = _tube_inputs(7, dev, crops=4)
    out = p4t_tube.tube_embed(x, anchor, ball, w_d, w_f)
    u = p4t_tube.samples(x, anchor, ball, 3, 2, 1)                       # (B, L, M, 96, 5)
    tube = u[..., :4] @ w_d.t() + u[..., 4:] @ w_f.t()                    # (B, L, M, 96, D)
    want = tube.reshape(u.shape[:3] + (3, 32, -1)).amax(dim=4).amax(dim=3)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-5)
    g = torch.randn(out.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    got = torch.autograd.grad((out * g).sum(), (w_d, w_f))
    exp = torch.autograd.grad((want * g).sum(), (w_d, w_f))
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
