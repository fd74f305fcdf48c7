"""The tube embedding's autograd Function (``ops/p4t_tube.py``, CPU path:
the plain versions the CUDA kernels are held to) against the materialised
tube (every sample's feature, then the max over the samples of each frame
and over the frames, as ``tests/p4t_reference.py`` takes it): the forward within f32
rounding, the weight gradients against autograd through the materialised
max, and ``gradcheck`` in f64."""

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_group import ball_query, furthest_point_sample
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_tube import (
    _dot,
    samples,
    tube_embed,
    tube_forward_ref,
)

torch.set_num_threads(1)


def inputs(seed: int, dtype=torch.float32, b=2, t=6, n=24, m=6, k=8, d=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.4, (b, t, n, 4))
    x[:, :, n // 2:] = x[:, :, : n - n // 2]  # repeated points: exact ties in the max
    x = torch.from_numpy(x).to(dtype)
    anchor = furthest_point_sample(x[:, 0::2], m)
    ball = ball_query(x, anchor, 0.7, k)
    w_d = torch.from_numpy(rng.uniform(-0.5, 0.5, (d, 4))).to(dtype).requires_grad_()
    w_f = torch.from_numpy(rng.uniform(-1, 1, (d, 1))).to(dtype).requires_grad_()
    return x, anchor, ball, w_d, w_f


def materialised(x, anchor, ball, w_d, w_f):
    """``(B, L, M, D)``: every sample's ``W_d·(p − a, dt) + W_f·f``, the max
    over each frame's K samples, then over the 3 frames."""
    b, t_len = x.shape[:2]
    l_len, m, kt, k = ball.shape[1:]
    out = []
    for bi in range(b):
        for l in range(l_len):
            frames = [min(max(2 * l + s - 1, 0), t_len - 1) for s in range(kt)]
            a = x[bi, 2 * l][anchor[bi, l]][:, :3]                               # (M, 3)
            pts = torch.stack([x[bi, f][ball[bi, l, :, s]] for s, f in enumerate(frames)], 1)
            dt = (torch.arange(kt, dtype=x.dtype) - kt // 2)[None, :, None, None]
            dt = dt.expand(m, kt, k, 1)
            u = torch.cat([pts[..., :3] - a[:, None, None], dt], -1)
            feat = u @ w_d.t() + pts[..., 3:] @ w_f.t()                         # (M, KT, K, D)
            out.append(feat.amax(dim=2).amax(dim=1))
    return torch.stack(out).reshape(b, l_len, m, -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_tube_forward_and_weight_gradients(seed):
    x, anchor, ball, w_d, w_f = inputs(seed)
    got = tube_embed(x, anchor, ball, w_d, w_f)
    want = materialised(x, anchor, ball, w_d, w_f)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(np.random.default_rng(seed + 9).normal(size=got.shape)).float()
    got_d, got_f = torch.autograd.grad((got * g).sum(), (w_d, w_f))
    want_d, want_f = torch.autograd.grad((want * g).sum(), (w_d, w_f))
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_f, want_f, rtol=1e-5, atol=1e-5)


def test_tube_argmax_is_the_first_maximal_sample():
    """The one-byte argmax is the lowest sample index that reaches the
    maximum, where repeated points tie exactly."""
    x, anchor, ball, w_d, w_f = inputs(3)
    w = torch.cat([w_d, w_f], 1).detach()
    best, arg = tube_forward_ref(x, anchor, ball, w, 3, 2, 1)
    feats = _dot(samples(x, anchor, ball, 3, 2, 1), w)                   # (B, L, M, S, D)
    hits = feats == best[:, :, :, None]
    assert torch.equal(best, feats.amax(dim=3))
    assert torch.equal(arg.long(), hits.int().argmax(dim=3))
    assert (hits.sum(dim=3) > 1).any()  # ties occurred


def test_tube_gradcheck_f64():
    x, anchor, ball, w_d, w_f = inputs(4, torch.float64, b=1, d=8)
    assert torch.autograd.gradcheck(
        lambda wd, wf: tube_embed(x, anchor, ball, wd, wf), (w_d, w_f), eps=1e-6, atol=1e-6)


def test_tube_refuses_bad_shapes():
    x, anchor, ball, w_d, w_f = inputs(5)
    with pytest.raises(ValueError, match="W_d"):
        tube_embed(x[..., :3], anchor, ball, w_d, w_f)
    with pytest.raises(ValueError, match="does not match"):
        tube_embed(x, anchor, ball[:, :, :, :2], w_d, w_f)
