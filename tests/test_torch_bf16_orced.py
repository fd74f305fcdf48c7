"""The port's bf16 OR-CED training step against the JAX package's, on the
CPU.

``COMPUTE_DTYPE="bfloat16"``, with ``BF16_ADAM_NU`` off (JAX:
``optax.adam(mu_dtype=bf16)`` with ``b2 = B1``) and on (``adam_lowmem``).
Per case one JAX ``build_orced`` state (NMAX 48, NSTEPS 12, PointNet 64,
latent 16, B 8) is carried into the port with
``convert.orced_state_from_jax``, bf16 moments included; both sides take
the same three batches, the same injected reparametrization draws and the
KL weight 0.5. The port's f32 step runs from the same state beside it.

Tolerances, for the reasons ``tests/test_torch_bf16_train.py`` gives
(bf16 values one rounding step apart move what follows; the JAX package's
own eager and ``jit`` bf16 gradients differ by a few percent), measured
here and held with a margin:

- the five losses rtol 2e-3;
- Adam's moments, L1 of the difference over L1 of JAX's over all leaves,
  5e-2, and any single leaf 0.15; the biases ahead of a train-mode
  BatchNorm have a zero gradient up to rounding, but a conv bias added in
  bf16 gets the rounding of 96 bf16 cotangents: |mu| < 2e-2 (measured
  5.2e-3 on JAX's side, 3.7e-4 on the port's);
- parameters within 2·lr a step, the mean difference of a leaf within
  lr/2; running statistics within 1e-2 of the leaf's largest magnitude
  (and the means' bias walk);
- nu: ``b2 = B1`` makes nu = 0.1·g² after a step, so the nu of those
  biases is held to 0.1·(2e-2 / 0.1)² = 4e-3, the square of the gradient
  the mu bound allows (measured 1.1e-4);
- the port's bf16 step closer to JAX's bf16 step than to the port's own
  f32 step, in L1 over mu and logvar of the step's train-mode encoder
  forward on the first batch (JAX's op by op, without ``jit``'s excess
  precision); the losses are no witness at these widths, where the bf16
  rounding noise of a value is as large as bf16's effect on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.train.orced import (
    build_orced as jax_build_orced,
    make_orced_train_step as jax_make_orced_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import orced_state_from_jax, orced_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.train import orced as port_orced

DIMS = dict(NMAX=48, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8)
STEPS = 3
KL_MULT = 0.5
LOSS_KEYS = ("rec_loss", "sup_loss", "trip_loss", "kl_loss", "tot_loss")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_grad(path) -> bool:
    keys = [getattr(k, "key", None) for k in path]
    if keys[-1] != "bias":
        return False
    if "PointNetBlock_0" in keys and keys[-2].startswith("TorchDense") or keys[-2] == "Conv_0":
        return True
    return "mean_learner" in keys and keys[-2] in ("TorchDense_0", "TorchDense_1", "TorchDense_2")


def _tree(state):
    return jax.device_get({
        "params": state.params, "batch_stats": state.batch_stats,
        "opt": {"count": state.opt[0].count, "mu": state.opt[0].mu, "nu": state.opt[0].nu},
    })


def _port_latents(pcfg, tree0, x, eps):
    mods, state = port_orced.build_orced(pcfg, device="cpu")
    orced_state_from_jax(tree0, mods, state)
    mods.train()
    with torch.no_grad():
        _, _, mu, logvar = mods.encoder(torch.from_numpy(x), eps=torch.from_numpy(eps))
    return np.concatenate([mu.numpy(), logvar.numpy()])


def _port_run(pcfg, tree0, data):
    mods, state = port_orced.build_orced(pcfg, device="cpu")
    orced_state_from_jax(tree0, mods, state)
    step = port_orced.make_orced_train_step(mods, pcfg)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    metrics, trees = [], []
    for i in range(STEPS):
        idx = torch.from_numpy(data["perm"][i]).long()
        state, m = step(state, x[idx], y[idx], KL_MULT, torch.from_numpy(data["eps"][i]))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(orced_state_to_jax(mods, state))
    return metrics, trees, state


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "bf16_nu16"])
def runs(request):
    nu16 = request.param
    cfg = JaxConfig(MODEL_NAME="PORT_ORCED", COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=nu16, **DIMS)
    models, state = jax_build_orced(cfg, jax.random.PRNGKey(0))
    tree0 = _tree(state)
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    data = dict(
        x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
        y=np.tile(np.arange(cfg.n_classes), n)[:n].astype(np.int32),
        perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32),
        eps=rng.normal(size=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)).astype(np.float32),
    )
    x0, eps0 = data["x"][data["perm"][0]], data["eps"][0]
    (_, _, mu, logvar), _ = models[0].apply(
        {"params": state.params["encoder"], "batch_stats": state.batch_stats["encoder"]},
        jnp.asarray(x0), train=True, eps=jnp.asarray(eps0), mutable=["batch_stats"])
    latents = {"jax": np.concatenate([np.asarray(mu), np.asarray(logvar)])}
    step = jax.jit(jax_make_orced_train_step(models, cfg))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_metrics, jax_trees = [], []
    for i in range(STEPS):
        idx = data["perm"][i]
        state, m = step(state, x[idx], y[idx], jnp.int32(i), jnp.float32(KL_MULT),
                        eps=jnp.asarray(data["eps"][i]))
        jax_metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        jax_trees.append(_tree(state))
    pcfg = Config.from_dict(cfg.to_dict())
    latents["port"] = _port_latents(pcfg, tree0, x0, eps0)
    latents["f32"] = _port_latents(pcfg.replace(COMPUTE_DTYPE="float32", BF16_ADAM_NU=False),
                                   tree0, x0, eps0)
    port_metrics, port_trees, pstate = _port_run(pcfg, tree0, data)
    return dict(cfg=cfg, nu16=nu16, jax_metrics=jax_metrics, jax_trees=jax_trees,
                port_metrics=port_metrics, port_trees=port_trees, latents=latents,
                port_state=pstate)


def _losses(metrics):
    return np.array([[m[k] for k in LOSS_KEYS] for m in metrics])


def test_losses_match_step_by_step(runs):
    got, want = _losses(runs["port_metrics"]), _losses(runs["jax_metrics"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0)
    assert [m["n_correct"] for m in runs["port_metrics"]] == \
        [m["n_correct"] for m in runs["jax_metrics"]]


def test_bf16_is_closer_to_jax_bf16_than_to_the_port_f32(runs):
    lat = runs["latents"]
    d_jax = np.abs(lat["port"] - lat["jax"]).sum()
    d_f32 = np.abs(lat["port"] - lat["f32"]).sum()
    assert d_jax < d_f32, (d_jax, d_f32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_moments(got, want, noise):
    num = den = 0.0
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        g, w = _f32(g), _f32(w)
        if _zero_grad(path):
            assert max(np.abs(g).max(), np.abs(w).max()) < noise, path
            continue
        d, n = np.abs(g - w).sum(), np.abs(w).sum()
        assert d <= 0.15 * n, (path, d / n)
        num, den = num + d, den + n
    assert num <= 5e-2 * den, num / den


@pytest.mark.parametrize("steps", [1, STEPS], ids=["one_step", "three_steps"])
def test_state_matches(runs, steps):
    got, want = runs["port_trees"][steps - 1], runs["jax_trees"][steps - 1]
    lr = runs["cfg"].LR
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == steps
    _assert_moments(got["opt"]["mu"], want["opt"]["mu"], noise=2e-2)
    _assert_moments(got["opt"]["nu"], want["opt"]["nu"], noise=4e-3)
    for (path, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        diff = np.abs(np.asarray(g) - np.asarray(w))
        assert diff.max() <= 2 * lr * steps * 1.01, (path, diff.max())
        if not _zero_grad(path):
            assert diff.mean() <= 0.5 * lr, (path, diff.mean() / lr)
    for (path, g), (_, w) in zip(_leaves(got["batch_stats"]), _leaves(want["batch_stats"])):
        w = np.asarray(w)
        atol = 1e-2 * float(np.abs(w).max())
        if getattr(path[-1], "key", None) == "mean":
            atol += 0.1 * lr * steps * (steps - 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=str(path))


def test_moments_are_stored_as_jax_stores_them(runs):
    opt = runs["port_state"].opt
    nu16 = runs["nu16"]
    assert all(v.dtype == torch.bfloat16 for v in opt.mu.values())
    assert all((v.dtype == torch.bfloat16) == nu16 for v in opt.nu.values())
    assert opt.optax_mu == (not nu16)
    jtree = runs["jax_trees"][-1]["opt"]
    assert {np.asarray(a).dtype.name for a in jax.tree_util.tree_leaves(jtree["mu"])} == \
        {"bfloat16"}
    assert {np.asarray(a).dtype.name for a in jax.tree_util.tree_leaves(jtree["nu"])} == \
        {"bfloat16" if nu16 else "float32"}
