"""``DEFERRED_DECODER_UPDATE`` on the CPU: the port's deferred decoder write
against the JAX package's, and against the port's plain schedule.

Against JAX: one JAX ``build_pcaa`` state (NMAX 48, NSTEPS 12, PointNet
64, latent 16, B 8) carried into the port (``convert.pcaa_state_from_jax``),
then one epoch of 3 batches through each side's ``make_epoch_fns`` train
epoch (the pending write at the top of steps 1 and 2, the flush after the
last), with the same injected noise; at f32, and at bf16 + nu16 + cache
(``BF16_WEIGHT_CACHE``). The port's own schedules: deferred against plain
over 2 epochs at f32, bitwise (JAX ``tests/test_deferred.py:69-92``); at
bf16 + nu16 + cache within JAX's own bounds (``tests/test_deferred.py:
94-142``). Then the resume state with each of the PR's options, and the
refusals JAX makes.

Tolerances and their reasons: at f32, ``tests/test_torch_train.py``'s
bounds and reasons (the deferred write at f32 moments is the plain
write's bits, so the JAX and port runs differ as their plain steps do); at
bf16 + nu16 + cache, ``tests/test_torch_bf16_train.py``'s (both sides
round to bf16 at the same places and sum f32 in other orders); deferred
against plain at bf16: losses rtol 0.05, atol 0.05, correct counts within
2 and the Adam counts equal (JAX's, since the write reads the stored,
rounded moments). The resume runs are bitwise (``tests/
test_torch_resume.py``'s method).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
    make_epoch_fns as jax_make_epoch_fns,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import pcaa_state_from_jax, pcaa_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import adam_init, adam_write_
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    make_epoch_fns,
    train_pcaa,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_train_state
from tests import test_torch_bf16_train as bf16_parity
from tests import test_torch_train as pcaa_parity
from tests.test_torch_resume import _folder

DIMS = dict(NMAX=48, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8, SUPERVISION_FREQUENCY=2)
STEPS = 3
LOSS_KEYS = ("rec_loss", "d_loss", "sup_loss", "tot_loss")
BF16_CACHE = dict(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True, BF16_WEIGHT_CACHE=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(0)
    n = STEPS * DIMS["BATCH_SIZE"]
    return dict(x=rng.normal(size=(n, 12, 48, 4)).astype(np.float32),
                y=rng.integers(0, 3, n).astype(np.int32),
                perm=rng.permutation(n).reshape(STEPS, DIMS["BATCH_SIZE"]).astype(np.int32),
                z0=rng.normal(size=(STEPS, 8, 16)).astype(np.float32),
                alphas=rng.uniform(size=(STEPS, 8, 1)).astype(np.float32))


# --- against the JAX package ---------------------------------------------------------------

def _against_jax(flags):
    cfg = JaxConfig(MODEL_NAME="DEF_V4", DEFERRED_DECODER_UPDATE=True, **DIMS, **flags)
    mods, state = jax_build_pcaa(cfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
    tree0 = pcaa_parity._tree(state)
    data = _data()
    train_epoch, _ = jax_make_epoch_fns(mods, cfg)
    state, jm = jax.jit(train_epoch)(state, jnp.asarray(data["x"]), jnp.asarray(data["y"]),
                                     jnp.asarray(data["perm"]),
                                     (jnp.asarray(data["z0"]), jnp.asarray(data["alphas"])))
    pcfg = Config.from_dict(cfg.to_dict())
    pmods, pstate = build_pcaa(pcfg, VARIANTS[VARIATION.V4], device="cpu")
    pcaa_state_from_jax(tree0, pmods, pstate)  # the weight copies refreshed from it
    ptrain, _ = make_epoch_fns(pmods, pcfg)
    pstate, pm = ptrain(pstate, torch.from_numpy(data["x"]), torch.from_numpy(data["y"]),
                        data["perm"], (torch.from_numpy(data["z0"]),
                                       torch.from_numpy(data["alphas"])))
    return cfg, jax.device_get(jm), pcaa_parity._tree(state), pm, pcaa_state_to_jax(pmods, pstate)


def test_f32_epoch_matches_jax():
    cfg, jm, want, pm, got = _against_jax({})
    for k in LOSS_KEYS + ("n_correct",):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), **pcaa_parity.LOSS_TOL,
                                   err_msg=k)
    for side in ("opt_g", "opt_d"):
        assert int(got[side]["count"]) == int(want[side]["count"]) == STEPS
        pcaa_parity._assert_moments(got[side]["mu"], want[side]["mu"], scale=STEPS, noise=1e-6)
        pcaa_parity._assert_moments(got[side]["nu"], want[side]["nu"], scale=2 * STEPS,
                                    noise=1e-12)
    # the decoder after the flush: the plain schedule's 3 writes on both sides
    pcaa_parity._assert_params(got["params_g"], want["params_g"], STEPS, cfg.LR)
    pcaa_parity._assert_params(got["params_d"], want["params_d"], STEPS, cfg.LR)


def test_bf16_nu16_cache_epoch_matches_jax():
    cfg, jm, want, pm, got = _against_jax(BF16_CACHE)
    got_l = np.stack([pm[k].numpy() for k in LOSS_KEYS], 1)
    want_l = np.stack([np.asarray(jm[k]) for k in LOSS_KEYS], 1)
    np.testing.assert_allclose(got_l, want_l, rtol=bf16_parity.LOSS_RTOL, atol=0)
    np.testing.assert_array_equal(pm["n_correct"].numpy(), np.asarray(jm["n_correct"]))
    for side, side_l1 in (("opt_g", 5e-2), ("opt_d", 5e-3)):
        assert int(got[side]["count"]) == int(want[side]["count"]) == STEPS
        bf16_parity._assert_moments(got[side]["mu"], want[side]["mu"], side_l1, noise=5e-3)
        bf16_parity._assert_moments(got[side]["nu"], want[side]["nu"], side_l1, noise=1e-5)
    for part in ("params_g", "params_d"):
        for (path, g), (_, w) in zip(bf16_parity._leaves(got[part]),
                                     bf16_parity._leaves(want[part])):
            diff = np.abs(np.asarray(g) - np.asarray(w))
            assert diff.max() <= 2 * cfg.LR * STEPS * 1.01, (path, diff.max())
            if not bf16_parity._zero_grad(path):
                assert diff.mean() <= 0.5 * cfg.LR, (path, diff.mean() / cfg.LR)


# --- the port's deferred schedule against its plain one ----------------------------------------

def _port_epochs(cfg, n_epochs):
    data = _data()
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
    train_epoch, _ = make_epoch_fns(mods, cfg)
    rng = np.random.default_rng(cfg.SEED)
    metrics = []
    for _ in range(n_epochs):
        perm = epoch_batch_indices(len(data["x"]), cfg.BATCH_SIZE, True, rng=rng)
        state, m = train_epoch(state, torch.from_numpy(data["x"]), torch.from_numpy(data["y"]),
                               perm)
        metrics.append(m)
    tensors = {f"m.{k}": v for k, v in mods.state_dict().items()}
    for name, o in (("g", state.opt_g), ("d", state.opt_d)):
        tensors[f"{name}.count"] = torch.tensor(o.count)
        tensors.update({f"{name}.mu.{k}": v for k, v in o.mu.items()})
        tensors.update({f"{name}.nu.{k}": v for k, v in o.nu.items()})
    return metrics, tensors


def test_f32_deferred_schedule_is_bitwise_the_plain_one():
    """Two epochs, the noise drawn by each run from its own generator (the
    same seed): parameters (the flushed decoder among them), running
    statistics, moments, counts and every step's metrics bitwise equal."""
    cfg = Config(MODEL_NAME="DEFB_V4", **DIMS)
    m_off, s_off = _port_epochs(cfg, 2)
    m_on, s_on = _port_epochs(cfg.replace(DEFERRED_DECODER_UPDATE=True), 2)
    assert s_off.keys() == s_on.keys()
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k
    for a, b in zip(m_off, m_on):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_bf16_nu16_cache_deferred_stays_close_to_plain():
    cfg = Config(MODEL_NAME="DEFC_V4", **DIMS, **BF16_CACHE)
    (m_off,), s_off = _port_epochs(cfg, 1)
    (m_on,), s_on = _port_epochs(cfg.replace(DEFERRED_DECODER_UPDATE=True), 1)
    assert torch.equal(s_off["g.count"], s_on["g.count"])
    assert all(torch.isfinite(v.float()).all() for v in s_on.values())
    np.testing.assert_allclose(m_on["n_correct"].numpy(), m_off["n_correct"].numpy(), atol=2.0)
    keys = sorted(k for k in m_off if k != "n_correct")
    np.testing.assert_allclose(np.concatenate([m_on[k].numpy() for k in keys]),
                               np.concatenate([m_off[k].numpy() for k in keys]),
                               rtol=0.05, atol=0.05)


def test_write_waits_for_a_first_step():
    """``adam_write_`` before any step (JAX's count-0 guard) writes nothing."""
    p = {"w": torch.randn(4, 3)}
    before = p["w"].clone()
    adam_write_(adam_init(p.items()), p, lr=1e-3, b1=0.9, b2=0.99)
    assert torch.equal(p["w"], before)


# --- the resume state with each option ---------------------------------------------------------

@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(1)

    def split(n):
        return (rng.normal(size=(n, 12, 48, 4)).astype(np.float32),
                (np.arange(n) % 3).astype(np.int32))

    return (*split(16), *split(8))


@pytest.mark.parametrize("kind,flags", [
    ("pcaa", {"DEFERRED_DECODER_UPDATE": True}),
    ("pcaa", {"DEFERRED_DECODER_UPDATE": True, **BF16_CACHE}),
    ("pcaa", {"COMPUTE_DTYPE": "bfloat16", "BF16_WEIGHT_CACHE": True, "FUSED_ADAM": True}),
    ("pcaa", {"FACTORED_ADAM_NU": True}),
    ("orced", {"FACTORED_ADAM_NU": True, "COMPUTE_DTYPE": "bfloat16",
               "BF16_WEIGHT_CACHE": True}),
], ids=["deferred", "deferred_bf16_cache", "cache_fused", "factored", "orced_factored_cache"])
def test_interrupted_run_equals_straight_run(tmp_path, arrays, kind, flags):
    """1 epoch, then a second call resuming for the second, against 2
    epochs straight: metrics, module files and the final resume state
    equal; the state holds a factored leaf's {r, c}, and no weight copy
    (rebuilt from the restored masters)."""
    def train(cfg):
        kw = dict(datasets=arrays, verbose=False, device="cpu")
        return train_orced(cfg, **kw) if kind == "orced" else train_pcaa(cfg, VARIATION.V4, **kw)

    name = "RES_ORCED" if kind == "orced" else "RES_V4"
    common = dict(SAVE_RESUME_STATE=True, CHECKPOINT_FREQUENCY=1, **DIMS, **flags)
    straight = Config(MODELS_PATH=str(tmp_path / "straight"), MODEL_NAME=name, EPOCHS=2, **common)
    train(straight)
    resumed = Config(MODELS_PATH=str(tmp_path / "resumed"), MODEL_NAME=name, EPOCHS=1, **common)
    train(resumed)
    tree, next_epoch, _ = load_train_state(os.path.join(resumed.run_dir(),
                                                        "train_state.msgpack"))
    assert next_epoch == 1
    opt = tree["opt" if kind == "orced" else "opt_g"]
    factored = [k for k, v in opt["nu"].items() if isinstance(v, dict)]
    assert factored == (["decoder.dense.4.weight"] if flags.get("FACTORED_ADAM_NU") else [])
    assert not any("bf16" in k or "cast" in k for k in tree)
    train(resumed.replace(EPOCHS=2))
    want, got = _folder(straight.run_dir()), _folder(resumed.run_dir())
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    for f in want[2]:
        assert got[2][f] == want[2][f], f


# --- refusals ---------------------------------------------------------------------------------

@pytest.mark.parametrize("variation,flags,match", [
    (VARIATION.V4, {"FUSED_ADAM": True}, "fused kernel writes params"),
    (VARIATION.V4, {"FACTORED_ADAM_NU": True}, "no per-element nu"),
    (VARIATION.V3, {}, "targets the decoder"),
], ids=["fused_adam", "factored", "no_decoder"])
def test_jax_refusals(variation, flags, match):
    cfg = Config(MODEL_NAME="DEFR_V4", DEFERRED_DECODER_UPDATE=True, **DIMS, **flags)
    with pytest.raises(ValueError, match=match):
        build_pcaa(cfg, VARIANTS[variation], device="cpu")
