"""The port's OR-CED models against the JAX package's flax modules.

Same weights on both sides (flax init, perturbed, running statistics moved
by train-mode applies, carried across by ``convert.py``), same numpy
inputs and the same pinned reparametrization draws, f32 on the CPU.
Tolerance rtol 1e-5, atol 1e-5, as ``tests/test_torch_models.py``: the two
frameworks sum in different orders. The run-folder round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.models import (
    GaussianMeanLearner as FlaxMeanLearner,
    ORCEDDecoder as FlaxORCEDDecoder,
    ORCEDEncoder as FlaxORCEDEncoder,
)
from opensetgaitrecognition_pcaa_tpu.train import run_folder as jax_run_folder

from opensetgaitrecognition_pcaa_tpu_torch import convert
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_orced_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.models.mean_learner import GaussianMeanLearner
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.train import run_folder

from tests.test_torch_run_folder import _assert_trees_identical

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(sup_latent_dim=8, pointnet_out_dim=16, dtc_filters=(4, 4, 4, 4, 4, 8))
N_CLASSES = 3
X_SHAPE = (3, 8, 10, 4)  # (B, T, N, C)


def _perturbed(variables, rng):
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        variables["params"],
    )
    return {**jax.device_get(variables), "params": params}


def flax_orced_encoder_vars(enc, x: np.ndarray, seed: int = 0, steps: int = 1):
    """Flax ``ORCEDEncoder`` variables: init, every parameter perturbed,
    the running statistics moved by ``steps`` train-mode applies (numpy
    leaves)."""
    rng = np.random.default_rng(seed)
    eps = jnp.zeros((x.shape[0], enc.sup_latent_dim), jnp.float32)
    v = _perturbed(enc.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False, eps=eps), rng)
    stats = v["batch_stats"]
    for _ in range(steps):
        _, muts = enc.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
                            train=True, eps=eps, mutable=["batch_stats"])
        stats = muts["batch_stats"]
    return {"params": v["params"], "batch_stats": jax.device_get(stats)}


def flax_mean_learner_vars(n_classes: int, latent: int, seed: int = 0, steps: int = 1):
    ml = FlaxMeanLearner(latent)
    oh = jnp.eye(n_classes, dtype=jnp.float32)
    v = _perturbed(ml.init(jax.random.PRNGKey(seed), oh, train=False), np.random.default_rng(seed))
    stats = v["batch_stats"]
    for _ in range(steps):
        _, muts = ml.apply({"params": v["params"], "batch_stats": stats}, oh, train=True,
                           mutable=["batch_stats"])
        stats = muts["batch_stats"]
    return {"params": v["params"], "batch_stats": jax.device_get(stats)}


@pytest.fixture(scope="module")
def encoder_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    eps = rng.normal(size=(X_SHAPE[0], DIMS["sup_latent_dim"])).astype(np.float32)
    flax_enc = FlaxORCEDEncoder(n_out_labels=N_CLASSES, **DIMS)
    enc_vars = flax_orced_encoder_vars(flax_enc, x, seed=1, steps=3)
    enc = ORCEDEncoder(N_CLASSES, in_features=4, **DIMS)
    enc.load_state_dict(convert.encoder_state_dict(enc_vars))  # strict
    return flax_enc, enc_vars, enc, x, eps


@pytest.mark.parametrize("train", [False, True])
def test_orced_encoder(encoder_case, train):
    flax_enc, enc_vars, enc, x, eps = encoder_case
    want, muts = flax_enc.apply(enc_vars, jnp.asarray(x), train=train, eps=jnp.asarray(eps),
                                mutable=["batch_stats"])
    port = ORCEDEncoder(N_CLASSES, in_features=4, **DIMS)
    port.load_state_dict(enc.state_dict())
    got = port.train(train)(torch.from_numpy(x), eps=torch.from_numpy(eps))
    for name, g, w in zip(("logits", "z", "mu", "logvar"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL, err_msg=name)
    stats = convert.encoder_variables(port.state_dict())["batch_stats"]
    want_stats = muts["batch_stats"] if train else enc_vars["batch_stats"]
    for g, w in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_wrapper", "plain"])
def test_fused_orced_encoder_apply(encoder_case, use_kernel):
    flax_enc, enc_vars, enc, x, eps = encoder_case
    want = flax_enc.apply(enc_vars, jnp.asarray(x), train=False, eps=jnp.asarray(eps))
    got = fused_orced_encoder_apply(enc.eval(), torch.from_numpy(x), eps=torch.from_numpy(eps),
                                    use_kernel=use_kernel)
    for name, g, w in zip(("logits", "z", "mu", "logvar"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_fused_orced_encoder_draws_from_the_generator(encoder_case):
    _, _, enc, x, _ = encoder_case
    xt = torch.from_numpy(x)
    got = fused_orced_encoder_apply(enc.eval(), xt, generator=torch.Generator().manual_seed(5))
    eps = torch.randn((x.shape[0], DIMS["sup_latent_dim"]), generator=torch.Generator().manual_seed(5))
    want = fused_orced_encoder_apply(enc, xt, eps=eps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="eps or a generator"):
        fused_orced_encoder_apply(enc, xt)


def test_orced_decoder():
    t, n, c = X_SHAPE[1:]
    z = np.random.default_rng(2).normal(size=(4, DIMS["sup_latent_dim"])).astype(np.float32)
    flax_dec = FlaxORCEDDecoder(nsteps=t, nmax_points=n, nfeatures=c)
    dec_vars = _perturbed(flax_dec.init(jax.random.PRNGKey(0), jnp.asarray(z)),
                          np.random.default_rng(3))
    want = flax_dec.apply(dec_vars, jnp.asarray(z))
    dec = ORCEDDecoder(DIMS["sup_latent_dim"], t, n, c)
    dec.load_state_dict(convert.decoder_state_dict(dec_vars))
    got = dec(torch.from_numpy(z))
    assert got.shape == want.shape == (4, t, n, c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_mean_learner_on_identity_one_hots(train):
    ml_vars = flax_mean_learner_vars(N_CLASSES, DIMS["sup_latent_dim"], seed=4, steps=2)
    oh = np.eye(N_CLASSES, dtype=np.float32)
    want, muts = FlaxMeanLearner(DIMS["sup_latent_dim"]).apply(
        ml_vars, jnp.asarray(oh), train=train, mutable=["batch_stats"])
    ml = GaussianMeanLearner(N_CLASSES, DIMS["sup_latent_dim"])
    ml.load_state_dict(convert.mean_learner_state_dict(ml_vars))  # strict
    got = ml.train(train)(torch.from_numpy(oh))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = convert.mean_learner_variables(ml.state_dict())["batch_stats"]
    want_stats = muts["batch_stats"] if train else ml_vars["batch_stats"]
    for g, w in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("tag", ["E", "G", "ML"])
def test_run_folder_round_trip(encoder_case, tag, tmp_path):
    """JAX tree → port module → port ``save_params`` → JAX ``load_params``:
    the tree comes back bit for bit."""
    _, enc_vars, _, _, _ = encoder_case
    if tag == "E":
        tree = enc_vars
        mod = ORCEDEncoder(N_CLASSES, in_features=4, **DIMS)
        to_sd, to_vars = convert.encoder_state_dict, convert.encoder_variables
    elif tag == "G":
        t, n, c = X_SHAPE[1:]
        z = jnp.zeros((1, DIMS["sup_latent_dim"]))
        tree = _perturbed(FlaxORCEDDecoder(nsteps=t, nmax_points=n, nfeatures=c)
                          .init(jax.random.PRNGKey(1), z), np.random.default_rng(6))
        mod = ORCEDDecoder(DIMS["sup_latent_dim"], t, n, c)
        to_sd, to_vars = convert.decoder_state_dict, convert.decoder_variables
    else:
        tree = flax_mean_learner_vars(N_CLASSES, DIMS["sup_latent_dim"], seed=7)
        mod = GaussianMeanLearner(N_CLASSES, DIMS["sup_latent_dim"])
        to_sd, to_vars = convert.mean_learner_state_dict, convert.mean_learner_variables
    mod.load_state_dict(to_sd(tree))  # strict: every key of the port's module is mapped
    path = str(tmp_path / "RUN" / f"RUN_{tag}.msgpack")
    run_folder.save_params(to_vars(mod.state_dict()), path)
    _assert_trees_identical(jax_run_folder.load_params(path), jax.device_get(tree))
