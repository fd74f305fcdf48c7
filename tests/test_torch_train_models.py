"""The port's training models and losses against the JAX package's, on the
CPU: decoder, critic and projection-head forwards against flax ``apply``,
the ``G``/``D``/``GPH`` tree maps both ways, ``seq_chamfer`` (both modes),
cross-entropy and the gradient penalty, values and gradients.

Same weights on both sides (flax init carried across by ``convert.py``),
same numpy inputs. Tolerance rtol 1e-5, atol 1e-5 (as
``tests/test_torch_models.py``): the frameworks sum in different orders.
Chamfer values of order 1e2 take rtol 1e-5 alone, as the ``xx + yy − 2xy``
form cancels alike on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.models import (
    CGDecoder as FlaxDecoder,
    CGDiscriminator as FlaxDiscriminator,
    ProjectionHead as FlaxHead,
)
from opensetgaitrecognition_pcaa_tpu.ops import (
    cross_entropy as jax_cross_entropy,
    gradient_penalty as jax_gradient_penalty,
    sample_distant_points as jax_sample_distant_points,
    seq_chamfer as jax_seq_chamfer,
)

from opensetgaitrecognition_pcaa_tpu_torch import convert
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import (
    CGDecoder,
    CGDiscriminator,
    ProjectionHead,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.centroids import sample_distant_points
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import seq_chamfer
from opensetgaitrecognition_pcaa_tpu_torch.ops.gp import gradient_penalty
from opensetgaitrecognition_pcaa_tpu_torch.ops.losses import cross_entropy

TOL = dict(rtol=1e-5, atol=1e-5)
LATENT, N_CLASSES, B = 16, 3, 8
T, N, C = 12, 64, 4  # decoder S = 3072: widths 192, 384, 768, 1536, 3072


def _init(module, *args):
    v = module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    return jax.device_get(v)


def _port(cls, variables, to_sd, *args):
    mod = cls(*args)
    mod.load_state_dict(to_sd(variables))
    return mod


@pytest.fixture(scope="module")
def latents():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(B, LATENT)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, B).astype(np.int32)
    return z, labels, np.eye(N_CLASSES, dtype=np.float32)[labels]


def test_decoder_forward(latents):
    z = np.concatenate([latents[0], latents[0][::-1]], axis=1)  # 2·latent wide
    flax_dec = FlaxDecoder(nsteps=T, nmax_points=N, nfeatures=C)
    variables = _init(flax_dec, z)
    want = flax_dec.apply(variables, jnp.asarray(z))
    dec = _port(CGDecoder, variables, convert.decoder_state_dict, 2 * LATENT, T, N, C)
    got = dec(torch.from_numpy(z))
    assert got.shape == (B, T, N, C)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_discriminator_forward(latents):
    z, _, oh = latents
    variables = _init(FlaxDiscriminator(), z, oh)
    want = FlaxDiscriminator().apply(variables, jnp.asarray(z), jnp.asarray(oh))
    disc = _port(CGDiscriminator, variables, convert.discriminator_state_dict, LATENT, N_CLASSES)
    got = disc(torch.from_numpy(z), torch.from_numpy(oh))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_projection_head_forward(latents):
    z = latents[0]
    variables = _init(FlaxHead(2 * LATENT), z)
    want = FlaxHead(2 * LATENT).apply(variables, jnp.asarray(z))
    head = _port(ProjectionHead, variables, convert.head_state_dict, LATENT, 2 * LATENT)
    np.testing.assert_allclose(head(torch.from_numpy(z)).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "tag,flax_mod,args,to_sd,to_vars",
    [
        ("G", lambda: FlaxDecoder(nsteps=T, nmax_points=N, nfeatures=C),
         lambda z, oh: (np.tile(z, 2),), convert.decoder_state_dict, convert.decoder_variables),
        ("D", FlaxDiscriminator, lambda z, oh: (z, oh), convert.discriminator_state_dict,
         convert.discriminator_variables),
        ("GPH", lambda: FlaxHead(2 * LATENT), lambda z, oh: (z,), convert.head_state_dict,
         convert.head_variables),
    ],
    ids=["G", "D", "GPH"],
)
def test_tree_maps_round_trip(latents, tag, flax_mod, args, to_sd, to_vars):
    z, _, oh = latents
    variables = _init(flax_mod(), *args(z, oh))
    back = to_vars(to_sd(variables))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(got, want)


def test_centroids_equal_the_jax_package():
    np.testing.assert_array_equal(
        sample_distant_points(LATENT, N_CLASSES, min_dist=10, sphere_radius=10, seed=42),
        jax_sample_distant_points(LATENT, N_CLASSES, min_dist=10, sphere_radius=10, seed=42),
    )


@pytest.mark.parametrize("avg_out", [True, False])
def test_seq_chamfer_value_and_gradient(avg_out):
    rng = np.random.default_rng(1)
    preds = rng.normal(size=(3, 5, 17, C)).astype(np.float32)
    gts = rng.normal(size=(3, 5, 23, C)).astype(np.float32)
    cot = np.ones(()) if avg_out else rng.normal(size=3)

    def jloss(p):
        return jnp.sum(jax_seq_chamfer(p, jnp.asarray(gts), avg_out=avg_out) * cot)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    out = seq_chamfer(p, torch.from_numpy(gts), avg_out=avg_out)
    assert out.shape == (() if avg_out else (3,))
    loss = torch.sum(out * torch.tensor(cot, dtype=torch.float32))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)


def test_cross_entropy_value_and_gradient(latents):
    _, labels, _ = latents
    logits = np.random.default_rng(2).normal(size=(B, N_CLASSES)).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.tensor(logits, requires_grad=True)
    got = cross_entropy(lt, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), **TOL)


def test_gradient_penalty_value_and_gradients(latents):
    """GP of the critic, differentiated (twice through the critic) with
    respect to the critic's parameters, as the critic step does."""
    z, _, oh = latents
    rng = np.random.default_rng(3)
    codes = rng.normal(size=(B, LATENT)).astype(np.float32)
    alphas = rng.uniform(size=(B, 1)).astype(np.float32)
    variables = _init(FlaxDiscriminator(), z, oh)

    def jgp(params):
        def critic(x):
            return FlaxDiscriminator().apply({"params": params}, x, jnp.asarray(oh))[:, 0]

        return jax_gradient_penalty(critic, jnp.asarray(z), jnp.asarray(codes), jnp.asarray(alphas))

    want, want_g = jax.value_and_grad(jgp)(variables["params"])
    disc = _port(CGDiscriminator, variables, convert.discriminator_state_dict, LATENT, N_CLASSES)
    oht = torch.from_numpy(oh)
    got = gradient_penalty(lambda x: disc(x, oht)[:, 0], torch.from_numpy(z),
                           torch.from_numpy(codes), torch.from_numpy(alphas))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    # the last bias does not reach the input gradient: JAX returns zeros
    got_g = convert.discriminator_variables({
        k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in disc.named_parameters()
    })
    for g, w in zip(jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves({"params": want_g})):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
