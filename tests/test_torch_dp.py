"""The port's data and tensor parallelism against the JAX package's sharded
step, and against its own single-device step, on the CPU: the f32 V4 step
and the train-mode PointNet (``tests/test_torch_dp_bf16_orced.py`` holds
the bf16 + nu16 and OR-CED steps).

The port's ranks are processes with gloo (``parallel/mesh.py::launch``)
running the rank functions of ``tests/torch_ranks.py``; JAX's step runs
jitted on the same ``create_mesh`` layout of the virtual CPU devices with
``state_shardings(min_dim=16)``, as ``tests/test_parallel.py:71-117`` does.
Both sides start from one JAX ``build_pcaa`` state (the
dims of ``tests/test_parallel.py``: NMAX 16, NSTEPS 8, PointNet 64, latent
16, B 8, ``MP_MIN_DIM`` 16, so the PointNet's, the TCN's last, the
decoder's, the critic's and the heads' kernels are sharded at MP 2) and
take the same batch and injected noise.

Tolerances and their reasons:

- against JAX's sharded step rtol 2e-3, atol 2e-4 and equal correct
  counts, ``tests/test_parallel.py``'s bound for any two mesh layouts;
- against the port's single-device step rtol 1e-4 on the losses (f32
  sums split over ranks and summed again); Adam's first moments, which
  after one step are (1 − b1)·g, rtol 1e-3 with atol 1e-4 of the leaf's
  largest magnitude (``tests/test_torch_train.py``'s bound for two f32
  gradients), except the dense and conv biases ahead of a train-mode
  BatchNorm, whose gradient is f32 noise about 0 (|mu| < 1e-6);
- the plain train-mode PointNet on shards against the unsharded call:
  1e-5 relative, to each value and to its leaf's largest magnitude (f32
  sums in other orders; the statistics' sums in f64); at bf16 storage
  1e-2, a bf16 rounding step, where a sum order moves a value across a
  rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.parallel import batch_sharding, create_mesh, state_shardings
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
    make_train_step as jax_make_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import pointnet_pool_train
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch
from tests.torch_ranks import pcaa_steps, pointnet_grads

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

DIMS = dict(NMAX=16, NSTEPS=8, POINTNET_OUT_DIM=64, DTC_FILTERS=(8, 8, 8, 8, 8, 16),
            SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2), BATCH_SIZE=8, MP_MIN_DIM=16)
LAYOUTS = {"dp2": (2, 1), "dp2_mp2": (2, 2)}
LOSS_KEYS = ("rec_loss", "d_loss", "sup_loss", "tot_loss")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, and in the ranks (``torch_ranks`` sets it too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(cfg, orced=False):
    rng = np.random.default_rng(0)
    b, latent = cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM
    data = dict(x=rng.normal(size=(b, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
                y=rng.integers(0, cfg.n_classes, b).astype(np.int32),
                perm=np.arange(b, dtype=np.int64)[None])
    if orced:
        data["eps"] = rng.normal(size=(1, b, latent)).astype(np.float32)
    else:
        data["z0"] = rng.normal(size=(1, b, latent)).astype(np.float32)
        data["alphas"] = rng.uniform(size=(1, b, 1)).astype(np.float32)
    return data


def _opt_tree(o):
    return {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}


def _jax_pcaa(cfg, dp, mp):
    """JAX ``build_pcaa`` state (key 0) → (its tree, the sharded step's metrics)."""
    mods, state = jax_build_pcaa(cfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
    tree = jax.device_get({"params_g": state.params_g, "params_d": state.params_d,
                           "batch_stats": state.batch_stats, "opt_g": _opt_tree(state.opt_g),
                           "opt_d": _opt_tree(state.opt_d), "centroids": state.centroids})
    data = _data(cfg)
    mesh = create_mesh(dp * mp, model_parallel=mp)
    st_sh = state_shardings(state, mesh, min_dim=cfg.MP_MIN_DIM)
    rows, whole = batch_sharding(mesh), NamedSharding(mesh, P())
    step = jax.jit(jax_make_train_step(mods, cfg),
                   in_shardings=(st_sh, rows, rows, whole, (rows, rows)),
                   out_shardings=(st_sh, None))
    put = jax.device_put
    _, m = step(jax.tree_util.tree_map(put, state, st_sh), put(data["x"], rows),
                put(data["y"], rows), put(jnp.int32(0), whole),
                (put(data["z0"][0], rows), put(data["alphas"][0], rows)))
    return tree, jax.device_get(m)


def _zero_grad(key: str) -> bool:
    """A dense or conv bias ahead of a train-mode BatchNorm."""
    parts = key.split(".")
    return parts[-1] == "bias" and ("pointnet.dense." in key or ".conv." in key or (
        parts[0] == "mean_learner" and parts[1] == "dense" and parts[2] in "012"))


def _assert_moments(got, want, noise=1e-6):
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        w = np.asarray(w, np.float32)
        if _zero_grad(key):
            assert max(np.abs(g).max(), np.abs(w).max()) < noise, key
            continue
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=key)


def _pcaa_case(layout, **flags):
    dp, mp = LAYOUTS[layout]
    cfg = JaxConfig(MODEL_NAME="DP_V4", **DIMS, **flags)
    tree, jax_m = _jax_pcaa(cfg, dp, mp)
    pcfg = Config.from_dict(cfg.to_dict())
    data = _data(cfg)
    solo = pcaa_steps(pcfg, VARIATION.V4, tree, data)
    sharded = launch(pcaa_steps, dp * mp, pcfg.replace(DP_DEVICES=dp, MP_DEVICES=mp),
                     VARIATION.V4, tree, data, backend="gloo")
    return jax_m, solo, sharded


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_v4_step_matches_jax_sharded_step_and_the_single_device_port(layout):
    jax_m, solo, sharded = _pcaa_case(layout)
    got = sharded["metrics"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k][0], jax_m[k], rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], solo["metrics"][k], rtol=1e-4, atol=0, err_msg=k)
    assert got["n_correct"][0] == jax_m["n_correct"] == solo["metrics"]["n_correct"][0]
    for side in ("opt_g", "opt_d"):
        assert sharded["state"][side]["count"] == 1
        _assert_moments(sharded["state"][side]["mu"], solo["state"][side]["mu"])
    for key, want in solo["state"]["modules"].items():
        if key.endswith((".mean", ".var")):  # the running statistics, global batch's
            np.testing.assert_allclose(sharded["state"]["modules"][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_fused_step_matches_the_single_device_fused_port():
    """``FUSED_POINTNET``/``FUSED_ADAM``: the train-mode PointNet's global
    statistics, its backward's global column sums and its column shards,
    and the Adam leaves chosen by their global shape; against the port's
    single-device fused step (itself held to JAX's in
    ``tests/test_torch_train.py``)."""
    cfg = Config(MODEL_NAME="DP_V4", FUSED_POINTNET=True, FUSED_ADAM=True, **DIMS)
    data = _data(cfg)
    solo = pcaa_steps(cfg, VARIATION.V4, None, data)
    sharded = launch(pcaa_steps, 4, cfg.replace(DP_DEVICES=2, MP_DEVICES=2), VARIATION.V4, None,
                     data, backend="gloo")
    for k in LOSS_KEYS:
        np.testing.assert_allclose(sharded["metrics"][k], solo["metrics"][k], rtol=1e-4,
                                   err_msg=k)
    assert sharded["metrics"]["n_correct"][0] == solo["metrics"]["n_correct"][0]
    for side in ("opt_g", "opt_d"):
        _assert_moments(sharded["state"][side]["mu"], solo["state"][side]["mu"])


@pytest.mark.parametrize("layout,store", [("dp2", "f32"), ("dp2_mp2", "f32"), ("mp2", "f32"),
                                          ("dp2_mp2", "bf16")])
def test_plain_pointnet_on_shards_matches_the_unsharded_call(layout, store):
    """``pointnet_pool_train``'s plain path on each rank's rows and column
    shards: the global statistics (f64 sums all-reduced), the backward's
    global ``g_gamma``/``g_beta`` and row count, the dgrad's sum over the
    model group; widths 4 → 32 → 32 → 64 → 64 at ``min_dim`` 32, so the
    last three layers are sharded and the first is not."""
    dp, mp = {"dp2": (2, 1), "dp2_mp2": (2, 2), "mp2": (1, 2)}[layout]
    dtype = torch.bfloat16 if store == "bf16" else torch.float32
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 24, 4)).astype(np.float32)
    widths = (4, 32, 32, 64, 64)
    params = [((rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
               rng.normal(size=o).astype(np.float32) * 0.1,
               rng.uniform(0.5, 1.5, size=o).astype(np.float32),
               rng.normal(size=o).astype(np.float32) * 0.1)
              for i, o in zip(widths[:-1], widths[1:])]
    cotangent = rng.normal(size=(4, 3, 64)).astype(np.float32)
    got = launch(pointnet_grads, dp * mp, x, params, cotangent, mp, 32, dtype, backend="gloo")

    leaves = [tuple(torch.from_numpy(p).requires_grad_(True) for p in layer) for layer in params]
    pooled, means, variances = pointnet_pool_train(torch.from_numpy(x), leaves, dtype)
    grads = torch.autograd.grad(torch.sum(pooled * torch.from_numpy(cotangent)),
                                [p for layer in leaves for p in layer])
    tol = dict(rtol=1e-5, atol=1e-6) if store == "f32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(got["pooled"], pooled.detach().numpy(), **tol)
    for i in range(4):
        np.testing.assert_allclose(got["means"][i], means[i].numpy(), **tol)
        np.testing.assert_allclose(got["vars"][i], variances[i].numpy(), **tol)
    for n, g in enumerate(grads):
        key = f"{n // 4}.{n % 4}"
        if n % 4 == 1:  # a bias ahead of the train-mode BatchNorm: rounding noise about 0
            np.testing.assert_allclose(got["grads"][key], g.numpy(), rtol=0,
                                       atol=10 * tol["atol"], err_msg=key)
            continue
        # relative to the leaf's largest magnitude: sums of many terms in other orders
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(got["grads"][key], g.numpy(), rtol=tol["rtol"],
                                   atol=tol["rtol"] * scale, err_msg=key)
