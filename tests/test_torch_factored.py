"""``FACTORED_ADAM_NU``: the port's factored Adam against the JAX package's
``adam_factored``, on the CPU.

The optimizer alone (``train/optim.py``) takes numpy inputs from a seed:
the JAX side a tree of JAX-layout leaves (a dense kernel ``(in, out)``),
the port the same leaves in its layout (the kernel transposed, ``(out,
in)``), so that JAX's row factor ``r`` is the port's ``r`` and its column
factor ``c`` the port's ``c``. Then whole V4 and ORCED steps at tiny dims
(NMAX 48, NSTEPS 12, PointNet 64, latent 16, B 8: the decoder's last
kernel, 1152 × 2304, is the one leaf of at least 2^20 elements) from one
JAX state carried into the port, with injected noise; the state's resume
tree round trip; and factored Adam over ranks (gloo, ``tests/
torch_ranks.py``) against one rank.

Tolerances and their reasons:

- a leaf below the threshold is plain Adam: bitwise equal to the port's
  ``adam_update_`` without ``optax_mu`` (the same expression), and within
  rtol 1e-6 of JAX's (f32 operations in the same order; XLA may fuse a
  multiply-add on the CPU);
- the factored formulas against JAX's: f32 sums over a row or a column in
  another order, rtol 1e-5 on r, c and the parameters' displacement over
  20 steps (an update is a ratio of such sums), the displacement with an
  atol of two f32 spacings of the largest weight, the rounding of the
  stored weights;
- a rank-1 gradient makes the factorization exact: one step within rtol
  1e-4, atol 1e-6 of plain Adam's (JAX ``tests/test_optim.py``'s bound);
- whole steps: ``tests/test_torch_train.py``'s bounds and reasons (and
  ``tests/test_torch_orced_train.py``'s for ORCED), a factored leaf's r
  and c held as second moments are;
- ranks against one rank: f32 sums split over ranks, losses rtol 1e-4, the
  gathered r and c rtol 1e-4 (``tests/test_torch_dp.py``'s bounds for a
  gradient sum; r sums partial row sums over the model group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.train.optim import adam_factored
from opensetgaitrecognition_pcaa_tpu.train.orced import (
    build_orced as jax_build_orced,
    make_orced_train_step as jax_make_orced_train_step,
)
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
    make_train_step as jax_make_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import (
    orced_state_from_jax,
    orced_state_to_jax,
    pcaa_state_from_jax,
    pcaa_state_to_jax,
)
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import (
    FACTORED_MIN_ELEMS,
    adam_init,
    adam_state_tree,
    adam_update_,
    load_adam_state_tree,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import build_orced, make_orced_train_step
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, build_pcaa, make_train_step
from tests import test_torch_orced_train as orced_parity
from tests import test_torch_train as pcaa_parity
from tests.torch_ranks import pcaa_steps

DIMS = dict(NMAX=48, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8)
STEPS = 3
LR, B1, B2 = 1e-3, 0.9, 0.99
FACTORED = "decoder.dense.4.weight"  # (2304, 1152): the one leaf of >= 2^20 elements


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the optimizer ------------------------------------------------------------------------

def _leaves(rng, shapes):
    """JAX-layout leaves: name → array (a 2-D leaf is a kernel (in, out))."""
    return {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}


def _port(tree):
    """JAX-layout arrays → port tensors of their own (2-D transposed)."""
    return {k: torch.from_numpy(np.array(a.T if a.ndim == 2 else a, order="C"))
            for k, a in tree.items()}


def _jax_steps(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, u)
    return jax.device_get(p), jax.device_get(state[0])


def _port_steps(params, grads, **init):
    p = _port(params)
    state = adam_init(p.items(), **init)
    for g in grads:
        adam_update_(state, p, _port(g), lr=LR, b1=B1, b2=B2)
    return p, state


def _to_jax(t):
    a = t.float().numpy()
    return a.T if a.ndim == 2 else a


SHAPES = {"kernel": (24, 40), "bias": (40,), "conv": (3, 4, 5), "head": (40, 3)}


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_small_leaves_are_plain_adam(mu_dtype):
    rng = np.random.default_rng(0)
    params = _leaves(rng, SHAPES)
    grads = [_leaves(rng, SHAPES) for _ in range(5)]
    mu_t = getattr(torch, mu_dtype)
    got, state = _port_steps(params, grads, mu_dtype=mu_t, factored_min_elems=FACTORED_MIN_ELEMS)
    assert not any(isinstance(v, dict) for v in state.nu.values())
    plain, _ = _port_steps(params, grads, mu_dtype=mu_t)
    for k in got:
        assert torch.equal(got[k], plain[k]), k
    want, jstate = _jax_steps(adam_factored(LR, b1=B1, b2=B2, mu_dtype=getattr(jnp, mu_dtype)),
                              params, grads)
    for k in got:
        np.testing.assert_allclose(_to_jax(got[k]), want[k], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(_to_jax(state.mu[k]), np.asarray(jstate.mu[k], np.float32),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_rank1_gradient_is_exact():
    """A rank-1 |g| makes the factorization exact: one factored step gives
    plain Adam's, and JAX's factored step."""
    rng = np.random.default_rng(5)
    g = {"w": (rng.normal(size=(24, 1)) @ rng.normal(size=(1, 40))).astype(np.float32)}
    p = {"w": np.zeros((24, 40), np.float32)}
    got, state = _port_steps(p, [g], factored_min_elems=1)
    assert isinstance(state.nu["w"], dict)
    plain, _ = _port_steps(p, [g])
    np.testing.assert_allclose(got["w"].numpy(), plain["w"].numpy(), rtol=1e-4, atol=1e-6)
    want, _ = _jax_steps(adam_factored(LR, b1=B1, b2=B2, min_elems=1), p, [g])
    np.testing.assert_allclose(_to_jax(got["w"]), want["w"], rtol=1e-5, atol=1e-9)


def test_state_sizes():
    """A factored leaf keeps r (its JAX rows, the port's columns) and c in
    f32, every other leaf a full nu; mu keeps its dtype and shape."""
    p = {"w": torch.zeros(128, 64), "small": torch.zeros(8, 4), "b": torch.zeros(64)}
    state = adam_init(p.items(), mu_dtype=torch.bfloat16, factored_min_elems=100)
    assert set(state.nu["w"]) == {"r", "c"}
    assert state.nu["w"]["r"].shape == (64,) and state.nu["w"]["c"].shape == (128,)
    assert all(t.dtype == torch.float32 for t in state.nu["w"].values())
    assert state.nu["small"].shape == (8, 4) and state.nu["b"].shape == (64,)
    assert all(m.dtype == torch.bfloat16 and m.shape == p[k].shape for k, m in state.mu.items())
    jstate = adam_factored(LR, min_elems=100).init({"w": jnp.zeros((64, 128))})
    assert jstate[0].nu["w"]["r"].shape == (64,) and jstate[0].nu["w"]["c"].shape == (128,)
    nbytes = sum(t.numel() * 4 for t in state.nu["w"].values())
    assert nbytes == (64 + 128) * 4 < 128 * 64 * 4


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_twenty_steps_every_2d_leaf_factored(mu_dtype):
    rng = np.random.default_rng(7)
    params = _leaves(rng, SHAPES)
    grads = [_leaves(rng, SHAPES) for _ in range(20)]
    got, state = _port_steps(params, grads, mu_dtype=getattr(torch, mu_dtype),
                             factored_min_elems=1)
    want, jstate = _jax_steps(adam_factored(LR, b1=B1, b2=B2, mu_dtype=getattr(jnp, mu_dtype),
                                            min_elems=1), params, grads)
    assert state.count == int(jstate.count) == 20
    for k in got:
        spacing = float(np.spacing(np.abs(want[k]).max()))
        np.testing.assert_allclose(_to_jax(got[k]) - params[k], want[k] - params[k], rtol=1e-5,
                                   atol=2 * spacing, err_msg=k)
        if params[k].ndim == 2:
            for f in ("r", "c"):
                np.testing.assert_allclose(state.nu[k][f].numpy(), jstate.nu[k][f], rtol=1e-5,
                                           err_msg=f"{k}.{f}")
        else:
            np.testing.assert_allclose(_to_jax(state.nu[k]), jstate.nu[k], rtol=1e-5, err_msg=k)


def test_state_tree_round_trips():
    """``adam_state_tree`` → ``load_adam_state_tree``: the factored {r, c}
    and the full nu come back bitwise; a tree of the other layout is
    refused."""
    rng = np.random.default_rng(3)
    params = _leaves(rng, SHAPES)
    _, state = _port_steps(params, [_leaves(rng, SHAPES)], mu_dtype=torch.bfloat16,
                           factored_min_elems=100)
    tree = adam_state_tree(state)
    assert set(tree["nu"]["kernel"]) == {"r", "c"}
    fresh = adam_init(_port(params).items(), mu_dtype=torch.bfloat16, factored_min_elems=100)
    load_adam_state_tree(fresh, tree)
    assert fresh.count == state.count == 1
    for k in state.mu:
        assert torch.equal(fresh.mu[k], state.mu[k])
        if isinstance(state.nu[k], dict):
            assert all(torch.equal(fresh.nu[k][f], state.nu[k][f]) for f in ("r", "c"))
        else:
            assert torch.equal(fresh.nu[k], state.nu[k])
    whole = adam_init(_port(params).items(), mu_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="factored moment"):
        load_adam_state_tree(whole, tree)


# --- whole steps against the JAX package -----------------------------------------------------

def _data(cfg, orced=False):
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    data = dict(x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
                y=(np.tile(np.arange(cfg.n_classes), n)[:n] if orced
                   else rng.integers(0, cfg.n_classes, n)).astype(np.int32),
                perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32))
    noise = dict(eps=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)) if orced else dict(
        z0=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM))
    for k, shape in noise.items():
        data[k] = rng.normal(size=shape).astype(np.float32)
    if not orced:
        data["alphas"] = rng.uniform(size=(STEPS, cfg.BATCH_SIZE, 1)).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def v4_runs():
    """V4 with FACTORED_ADAM_NU, JAX and port from one JAX state, 3 steps."""
    cfg = JaxConfig(MODEL_NAME="FAC_V4", SUPERVISION_FREQUENCY=2, FACTORED_ADAM_NU=True, **DIMS)
    mods, state = jax_build_pcaa(cfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
    tree0 = pcaa_parity._tree(state)
    data = _data(cfg)
    step = jax.jit(jax_make_train_step(mods, cfg))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_metrics = []
    for i in range(STEPS):
        idx = data["perm"][i]
        state, m = step(state, x[idx], y[idx], jnp.int32(i),
                        (jnp.asarray(data["z0"][i]), jnp.asarray(data["alphas"][i])))
        jax_metrics.append(jax.device_get(m))
    pcfg = Config.from_dict(cfg.to_dict())
    pmods, pstate = build_pcaa(pcfg, VARIANTS[VARIATION.V4], device="cpu")
    pcaa_state_from_jax(tree0, pmods, pstate)
    pstep = make_train_step(pmods, pcfg)
    xt, yt = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    port_metrics = []
    for i in range(STEPS):
        idx = torch.from_numpy(data["perm"][i]).long()
        pstate, m = pstep(pstate, xt[idx], yt[idx], i,
                          (torch.from_numpy(data["z0"][i]), torch.from_numpy(data["alphas"][i])))
        port_metrics.append(m)
    return dict(cfg=cfg, tree0=tree0, jax=pcaa_parity._tree(state), jax_metrics=jax_metrics,
                port=pcaa_state_to_jax(pmods, pstate), port_metrics=port_metrics, state=pstate)


def test_v4_step_matches_jax(v4_runs):
    r = v4_runs
    assert isinstance(r["state"].opt_g.nu[FACTORED], dict)
    assert sum(isinstance(v, dict) for v in r["state"].opt_g.nu.values()) == 1
    assert not any(isinstance(v, dict) for v in r["state"].opt_d.nu.values())
    assert isinstance(r["tree0"]["opt_g"]["nu"]["decoder"]["TorchDense_4"]["kernel"], dict)
    for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss", "n_correct"):
        want = np.array([float(m[key]) for m in r["jax_metrics"]])
        got = np.array([float(m[key]) for m in r["port_metrics"]])
        np.testing.assert_allclose(got, want, **pcaa_parity.LOSS_TOL, err_msg=key)
    got, want = r["port"], r["jax"]
    for side in ("opt_g", "opt_d"):
        assert int(got[side]["count"]) == int(want[side]["count"]) == STEPS
        assert not r["state"].opt_g.optax_mu
        pcaa_parity._assert_moments(got[side]["mu"], want[side]["mu"], scale=STEPS, noise=1e-6)
        pcaa_parity._assert_moments(got[side]["nu"], want[side]["nu"], scale=2 * STEPS,
                                    noise=1e-12)
    pcaa_parity._assert_params(got["params_g"], want["params_g"], STEPS, r["cfg"].LR)
    pcaa_parity._assert_params(got["params_d"], want["params_d"], STEPS, r["cfg"].LR)


@pytest.fixture(scope="module")
def orced_runs():
    cfg = JaxConfig(MODEL_NAME="FAC_ORCED", FACTORED_ADAM_NU=True, **DIMS)
    models, state = jax_build_orced(cfg, jax.random.PRNGKey(0))
    tree0 = orced_parity._tree(state)
    data = _data(cfg, orced=True)
    step = jax.jit(jax_make_orced_train_step(models, cfg))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_metrics = []
    for i in range(STEPS):
        idx = data["perm"][i]
        state, m = step(state, x[idx], y[idx], jnp.int32(i), jnp.float32(0.5),
                        eps=jnp.asarray(data["eps"][i]))
        jax_metrics.append(jax.device_get(m))
    pcfg = Config.from_dict(cfg.to_dict())
    pmods, pstate = build_orced(pcfg, device="cpu")
    orced_state_from_jax(tree0, pmods, pstate)
    pstep = make_orced_train_step(pmods, pcfg)
    xt, yt = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    port_metrics = []
    for i in range(STEPS):
        idx = torch.from_numpy(data["perm"][i]).long()
        pstate, m = pstep(pstate, xt[idx], yt[idx], 0.5, torch.from_numpy(data["eps"][i]))
        port_metrics.append(m)
    return dict(cfg=cfg, jax=orced_parity._tree(state), jax_metrics=jax_metrics,
                port=orced_state_to_jax(pmods, pstate), port_metrics=port_metrics, state=pstate)


def test_orced_step_matches_jax(orced_runs):
    """ORCED's factored Adam takes b2 = B1, as JAX passes it."""
    r = orced_runs
    assert isinstance(r["state"].opt.nu[FACTORED], dict)
    for key in ("rec_loss", "sup_loss", "trip_loss", "kl_loss", "tot_loss"):
        want = np.array([float(m[key]) for m in r["jax_metrics"]])
        got = np.array([float(m[key]) for m in r["port_metrics"]])
        np.testing.assert_allclose(got, want, **orced_parity.LOSS_TOL, err_msg=key)
    got, want = r["port"]["opt"], r["jax"]["opt"]
    assert int(got["count"]) == int(want["count"]) == STEPS
    for key, scale in (("mu", STEPS), ("nu", 2 * STEPS)):
        for (path, g), (_, w) in zip(pcaa_parity._leaves(got[key]),
                                     pcaa_parity._leaves(want[key])):
            w = np.asarray(w)
            if orced_parity._zero_grad(path):  # noise, held to its kernel's atol
                layer = want[key]
                for k in path[:-1]:
                    layer = layer[k.key]
                noise = 1e-4 * scale * float(np.abs(np.asarray(layer["kernel"])).max())
                assert max(np.abs(g).max(), np.abs(w).max()) < noise, path
                continue
            np.testing.assert_allclose(g, w, rtol=1e-3 * scale,
                                       atol=1e-4 * scale * float(np.abs(w).max()),
                                       err_msg=str(path))
    lr = r["cfg"].LR
    for (path, g), (_, w) in zip(pcaa_parity._leaves(r["port"]["params"]),
                                 pcaa_parity._leaves(r["jax"]["params"])):
        diff = np.abs(np.asarray(g) - np.asarray(w))
        assert diff.max() <= 2 * lr * STEPS * 1.01, (path, diff.max())
        if not orced_parity._zero_grad(path):
            assert np.mean(diff > 1e-6) < 0.01, (path, np.mean(diff > 1e-6))


# --- over ranks ----------------------------------------------------------------------------

MESH_DIMS = dict(DIMS, MP_MIN_DIM=16)


@pytest.fixture(scope="module")
def mesh_runs():
    cfg = Config(MODEL_NAME="FAC_MESH_V4", FACTORED_ADAM_NU=True, FUSED_POINTNET=True,
                 **MESH_DIMS)
    data = _data(cfg)
    data = {k: v[:1] if k in ("perm", "z0", "alphas") else v for k, v in data.items()}
    solo = pcaa_steps(cfg, VARIATION.V4, None, data)
    runs = {"solo": solo}
    for name, (dp, mp) in (("dp2", (2, 1)), ("mp2", (1, 2))):
        runs[name] = launch(pcaa_steps, dp * mp, cfg.replace(DP_DEVICES=dp, MP_DEVICES=mp),
                            VARIATION.V4, None, data, backend="gloo")
    return runs


@pytest.mark.parametrize("layout", ["dp2", "mp2"])
def test_factored_adam_over_ranks_matches_one_rank(mesh_runs, layout):
    """DP 2 and MP 2 (the factored leaf's output rows split over the model
    group, r summed over it) against one rank; the gathered state holds the
    whole {r, c}."""
    solo, got = mesh_runs["solo"], mesh_runs[layout]
    for k in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
        np.testing.assert_allclose(got["metrics"][k], solo["metrics"][k], rtol=1e-4, err_msg=k)
    nu, want = got["state"]["opt_g"]["nu"][FACTORED], solo["state"]["opt_g"]["nu"][FACTORED]
    assert set(nu) == {"r", "c"}
    assert nu["r"].shape == (1152,) and nu["c"].shape == (2304,)
    for f in ("r", "c"):
        np.testing.assert_allclose(nu[f], want[f], rtol=1e-4, err_msg=f)
    np.testing.assert_allclose(got["state"]["modules"]["g." + FACTORED],
                               solo["state"]["modules"]["g." + FACTORED], rtol=0,
                               atol=2 * 1e-4 * 1.01)
