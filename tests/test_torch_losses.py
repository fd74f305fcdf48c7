"""The port's ORCED losses against the JAX package's, values and gradients.

Same numpy inputs on both sides, f32 on the CPU; ``torch.autograd``
against ``jax.grad`` at rtol 1e-5 (sums in other orders). The mining masks
are compared exactly, so each seeded input is asserted, as a precondition,
to hold no pair within 1e-5 of a mining boundary: the two frameworks' f32
``z @ z.T`` may round apart by about 1e-7, which must not flip a pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.ops import losses as jax_losses

from opensetgaitrecognition_pcaa_tpu_torch.ops import losses

TOL = dict(rtol=1e-5, atol=1e-7)
MARGIN = 1e-5


def _normalized(rng, b, d, spread=1.0):
    z = rng.normal(size=(b, d)) * spread
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)


def _boundary_gap(z: np.ndarray, labels: np.ndarray, epsilon: float = 0.1) -> float:
    sim = z.astype(np.float64) @ z.T.astype(np.float64)
    same = labels[:, None] == labels[None, :]
    pos, neg = same & ~np.eye(len(z), dtype=bool), ~same
    hardest_neg = np.where(neg, sim, -np.inf).max(1)
    easiest_pos = np.where(pos, sim, np.inf).min(1)
    with np.errstate(invalid="ignore"):
        gaps = np.abs(np.concatenate([(sim - (hardest_neg[:, None] + epsilon))[pos],
                                      (sim - (easiest_pos[:, None] - epsilon))[neg]]))
    gaps = gaps[np.isfinite(gaps)]
    return float(gaps.min()) if len(gaps) else np.inf


# (seed, labels): a batch of 16 over 4 classes; an anchor whose class has
# no other member (the +inf sentinel of its easiest positive); one class
# only (no negatives: the -inf sentinel); and a batch whose classes sit
# far apart, so no mined triplet violates the margin
CASES = {
    "mixed": (0, np.repeat(np.arange(4), 4)),
    "anchor_without_positive": (1, np.array([0, 0, 0, 1, 1, 1, 2, 3, 3, 3])),
    "one_class": (2, np.zeros(6, int)),
}


def _case(name):
    seed, labels = CASES[name]
    z = _normalized(np.random.default_rng(seed), len(labels), 8)
    return z, labels.astype(np.int32)


def _separated():
    """Each class a tight cluster around its own axis: every positive
    distance is far below every negative distance minus the margin."""
    rng = np.random.default_rng(3)
    labels = np.repeat(np.arange(3), 4).astype(np.int32)
    z = np.eye(8)[labels] + 0.01 * rng.normal(size=(12, 8))
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32), labels


@pytest.mark.parametrize("name", list(CASES))
def test_mining_masks_equal_the_jax_package(name):
    z, labels = _case(name)
    assert _boundary_gap(z, labels) > MARGIN
    got = losses.multi_similarity_mine(torch.from_numpy(z), torch.from_numpy(labels))
    want = jax_losses.multi_similarity_mine(jnp.asarray(z), jnp.asarray(labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name == "anchor_without_positive":
        assert not got[0][6].any() and not got[1][6].any()  # the sentinels keep nothing
    if name == "one_class":
        assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("name", list(CASES) + ["no_violating_triplet"])
def test_triplet_loss_and_gradient_equal_the_jax_package(name):
    z, labels = _separated() if name == "no_violating_triplet" else _case(name)
    assert _boundary_gap(z, labels) > MARGIN
    zt = torch.from_numpy(z).requires_grad_()
    got = losses.triplet_loss_with_ms_miner(zt, torch.from_numpy(labels), margin=0.5)
    got.backward()
    want, want_grad = jax.value_and_grad(
        lambda e: jax_losses.triplet_loss_with_ms_miner(e, jnp.asarray(labels), margin=0.5)
    )(jnp.asarray(z))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_grad), **TOL)
    if name == "mixed":
        assert got.item() > 0
    if name in ("no_violating_triplet", "one_class"):
        assert got.item() == 0.0 and not zt.grad.any()


def test_cg_kl_divergence_and_gradients_equal_the_jax_package():
    rng = np.random.default_rng(4)
    mu, logvar, mu_k = (rng.normal(size=(9, 16)).astype(np.float32) for _ in range(3))
    args = [torch.from_numpy(a).requires_grad_() for a in (mu, logvar, mu_k)]
    got = losses.cg_kl_divergence(*args)
    got.backward()
    want, grads = jax.value_and_grad(jax_losses.cg_kl_divergence, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (mu, logvar, mu_k)))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for a, g in zip(args, grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **TOL)


def test_cross_entropy_equals_the_jax_package():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 7).astype(np.int32)
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
