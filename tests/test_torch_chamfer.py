"""The port's Chamfer wrapper against the JAX package's Pallas Chamfer.

``seq_chamfer_kernel`` on CPU tensors runs its plain version (the kernel
exists only on the card); ``seq_chamfer_pallas`` runs in interpret mode, as
``tests/test_pallas.py`` runs it. Same numpy inputs on both sides, f32.

Tolerances and their reasons:

- values rtol 1e-5, atol 1e-5: the Pallas kernel forms the distances as one
  augmented contraction ``[-2x, |x|², 1]·[y, 1, |y|²]``, the port as
  ``(|x|² + |y|²) − 2x·y``; both cancel in f32, in other orders;
- against a direct f64 ``(x − y)²`` oracle rtol 1e-4: the f32 cancellation
  of ``|x|² + |y|² − 2x·y`` for the nearest (small) distances;
- gradients rtol 1e-4, atol 1e-5: the same argmins (first index on ties,
  zero-padded points tie exactly), scatter-added in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.ops.pallas import seq_chamfer_pallas

from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, T, N gt points, M predicted points, zero-padded)
SHAPES = {
    "n150": (2, 3, 150, 150, False),
    "ragged_n37_m53": (2, 3, 37, 53, False),
    "zero_padded": (2, 3, 48, 48, True),
}


def _clouds(b, t, n, m, padded, seed=0):
    """``(preds (B, T, M, C), gts (B, T, N, C))``; zero-padded clouds hold
    a random number of real points per frame and zeros after, as crops do."""
    rng = np.random.default_rng(seed)
    gts = rng.normal(size=(b, t, n, 4)).astype(np.float32)
    preds = (0.7 * rng.normal(size=(b, t, m, 4)) + 0.2).astype(np.float32)
    if padded:
        for cloud in (gts, preds):
            for bi in range(b):
                for ti in range(t):
                    cloud[bi, ti, rng.integers(1, cloud.shape[2]):] = 0.0
    return preds, gts


def _oracle_frames(preds, gts):
    d = ((gts.astype(np.float64)[:, :, :, None, :] - preds.astype(np.float64)[:, :, None]) ** 2)
    d = d.sum(-1)  # (B, T, N, M)
    return d.min(axis=2).sum(axis=2) + d.min(axis=3).sum(axis=2)


@pytest.mark.parametrize("avg_out", [True, False], ids=["mean", "per_sample"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_forward_matches_pallas(shape, avg_out):
    preds, gts = _clouds(*SHAPES[shape])
    with pltpu.force_tpu_interpret_mode():
        want = seq_chamfer_pallas(jnp.asarray(preds), jnp.asarray(gts), avg_out=avg_out)
    before = ck.seq_chamfer_kernel.launches
    got = ck.seq_chamfer_kernel(torch.from_numpy(preds), torch.from_numpy(gts), avg_out=avg_out)
    assert ck.seq_chamfer_kernel.launches == before  # the CPU runs the plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_frames_match_f64_oracle(shape):
    preds, gts = _clouds(*SHAPES[shape], seed=1)
    got = ck.frame_chamfer_kernel(torch.from_numpy(preds), torch.from_numpy(gts))
    np.testing.assert_allclose(got.numpy(), _oracle_frames(preds, gts), rtol=1e-4, atol=0)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_gradients_match_pallas(shape):
    """d/d(preds, gts) of a weighted sum of the per-sample distances."""
    preds, gts = _clouds(*SHAPES[shape], seed=2)
    w = np.random.default_rng(3).uniform(0.5, 2.0, preds.shape[0]).astype(np.float32)

    def loss(p, g):
        return jnp.sum(jnp.asarray(w) * seq_chamfer_pallas(p, g, avg_out=False))

    with pltpu.force_tpu_interpret_mode():
        want_p, want_g = jax.grad(loss, argnums=(0, 1))(jnp.asarray(preds), jnp.asarray(gts))
    p = torch.from_numpy(preds).requires_grad_()
    g = torch.from_numpy(gts).requires_grad_()
    (torch.from_numpy(w) * ck.seq_chamfer_kernel(p, g, avg_out=False)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p), **GRAD_TOL)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_g), **GRAD_TOL)


def test_mean_gradient_matches_pallas():
    preds, gts = _clouds(*SHAPES["ragged_n37_m53"], seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda p: seq_chamfer_pallas(p, jnp.asarray(gts)))(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_()
    ck.seq_chamfer_kernel(p, torch.from_numpy(gts)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda p, g: (p.double(), g.double()), "float32"),
        (lambda p, g: (p.transpose(2, 3), g), "contiguous"),
        (lambda p, g: (p[0], g[0]), r"\(B, T, N, C\)"),
        (lambda p, g: (p, g[:1]), "differ"),
        (lambda p, g: (p.repeat(1, 1, 1, 3), g.repeat(1, 1, 1, 3)), None),
        (lambda p, g: (p[:, :, :0], g), "no points"),
        (lambda p, g: (p[..., :3].contiguous(), g[..., :3].contiguous()), None),
    ],
    ids=["dtype", "contiguity", "rank", "batch", "c12", "no_points", "c3"],
)
def test_argument_checks(mutate, match):
    """Each bad argument raises; any channel count passes (``match``
    None): the wrapper pads C to a built kernel or takes the run-time-C
    kernel."""
    preds, gts = (torch.from_numpy(a) for a in _clouds(2, 3, 5, 7, False))
    if match is None:
        ck._check_cuda_args(*mutate(preds, gts))
        return
    with pytest.raises(ValueError, match=match):
        ck._check_cuda_args(*mutate(preds, gts))


def test_argument_checks_accept_main_path_shapes():
    preds, gts = (torch.from_numpy(a) for a in _clouds(2, 3, 150, 150, True))
    ck._check_cuda_args(preds, gts)


def test_argument_checks_accept_five_channels():
    """A crop keeps a fifth channel, the power in dB, when NFEATURES = 5."""
    preds, gts = (torch.from_numpy(a) for a in _clouds(2, 3, 5, 7, False))
    ck._check_cuda_args(torch.cat([preds, preds[..., :1]], -1), torch.cat([gts, gts[..., :1]], -1))


def test_no_kernel_for_other_devices():
    preds, gts = (torch.from_numpy(a).to("meta") for a in _clouds(1, 2, 5, 5, False))
    with pytest.raises(ValueError, match="no kernel"):
        ck.seq_chamfer_kernel(preds, gts)
