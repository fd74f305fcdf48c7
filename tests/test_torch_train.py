"""The port's V4 training against the JAX package's, on the CPU.

One JAX ``build_pcaa`` state (tier-1 dims: NMAX 64, NSTEPS 12, PointNet
64, latent 16, B 8) is carried into the port with
``convert.pcaa_state_from_jax``. Both sides then take the same batches and
the same injected noise ``(z0, alphas)``: one step, and an epoch of three
(``SUPERVISION_FREQUENCY=2``, so the middle step has no CE term), with
``FUSED_POINTNET``/``FUSED_ADAM`` both off and both on (the JAX package's
Pallas kernels in interpret mode). For the fused run the JAX optimizer
states are recast to ``adam_lowmem``'s layout, as its ``build_pcaa`` makes
them for ``FUSED_ADAM``; their values (zeros) are the same.

Tolerances and their reasons:

- losses rtol 1e-4: f32 sums in other orders, through a 6.3M-parameter
  decoder and a Chamfer loss whose ``xx + yy − 2xy`` form cancels;
- Adam's first moments: after one step mu = (1 − b1)·g, so they hold the
  gradients. rtol 1e-3 with atol 1e-4 of the leaf's largest magnitude:
  the gradients of two f32 implementations, through train-mode BatchNorm
  and the gradient penalty's double backward; second moments nu =
  (1 − b2)·g², the same, doubled; both scaled by the number of steps;
- the dense and conv biases ahead of a train-mode BatchNorm have a zero
  gradient (the batch mean removes them): both sides hold f32 noise there,
  so their moments are held to |mu| < 1e-6 and |nu| < 1e-12 instead;
- parameters: Adam's first step moves each weight by about lr·sign(g), so
  where g is only noise the two sides may step apart by up to 2·lr per
  step. Each parameter is held to 2·lr·steps, and outside those biases
  fewer than 1% of the weights may be more than 1e-6 apart;
- running statistics rtol 1e-4, atol 1e-6 after one step; a running mean
  follows its layer's bias, which walks apart by up to 2·lr a step as just
  said, so after s steps the means take atol 0.1·lr·s·(s − 1) more.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.data.dataset import (
    epoch_batch_indices as jax_epoch_batch_indices,
)
from opensetgaitrecognition_pcaa_tpu.infer.pcaa import pcaa_inference as jax_pcaa_inference
from opensetgaitrecognition_pcaa_tpu.train.optim import ScaleByAdamLowmemState, adam_lowmem
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
    make_train_step as jax_make_train_step,
)
from opensetgaitrecognition_pcaa_tpu.train.run_folder import load_params as jax_load_params

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import pcaa_state_from_jax, pcaa_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
    RadarCropDataset,
    epoch_batch_indices,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    make_epoch_fns,
    make_train_step,
    train_pcaa,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import run_completed

DIMS = dict(NMAX=64, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8)
STEPS = 3
LOSS_TOL = dict(rtol=1e-4, atol=0)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)


def _zero_grad(path) -> bool:
    """A dense or conv bias ahead of a train-mode BatchNorm."""
    keys = [getattr(k, "key", None) for k in path]
    return keys[-1] == "bias" and ("PointNetBlock_0" in keys and keys[-2].startswith("TorchDense")
                                   or keys[-2] == "Conv_0")


def _tree(state):
    """The JAX state's pieces that the port carries, as numpy."""
    def opt(o):
        return {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}

    return jax.device_get({
        "params_g": state.params_g, "params_d": state.params_d,
        "batch_stats": state.batch_stats, "opt_g": opt(state.opt_g),
        "opt_d": opt(state.opt_d), "centroids": state.centroids,
    })


@pytest.fixture(scope="module")
def start():
    """→ (JAX cfg, JAX modules, JAX state, data): one JAX build_pcaa state."""
    cfg = JaxConfig(MODEL_NAME="PORT_V4", SUPERVISION_FREQUENCY=2, **DIMS)
    mods, state = jax_build_pcaa(cfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    data = dict(
        x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
        y=rng.integers(0, cfg.n_classes, n).astype(np.int32),
        perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32),
        z0=rng.normal(size=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)).astype(np.float32),
        alphas=rng.uniform(size=(STEPS, cfg.BATCH_SIZE, 1)).astype(np.float32),
    )
    return cfg, mods, state, data


def _jax_run(cfg, mods, state, data):
    """Three jitted JAX steps → (tree after 1 step, after 3, per-step metrics)."""
    if cfg.FUSED_ADAM:
        mods = dataclasses.replace(
            mods, tx_g=adam_lowmem(cfg.LR, b1=cfg.B1, b2=cfg.B2),
            tx_d=adam_lowmem(cfg.LR, b1=cfg.B1, b2=cfg.B2),
        )
        state = state.replace(**{
            k: (ScaleByAdamLowmemState(*getattr(state, k)[0]),) + tuple(getattr(state, k)[1:])
            for k in ("opt_g", "opt_d")
        })
    step = jax.jit(jax_make_train_step(mods, cfg))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    trees, metrics = [], []
    for i in range(STEPS):
        idx = data["perm"][i]
        state, m = step(state, x[idx], y[idx], jnp.int32(i),
                        (jnp.asarray(data["z0"][i]), jnp.asarray(data["alphas"][i])))
        metrics.append(jax.device_get(m))
        trees.append(_tree(state))
    return trees[0], trees[-1], metrics


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "fused"])
def runs(request, start):
    """JAX and port, from the same state, with both flags off or both on."""
    cfg0, mods, state, data = start
    cfg = cfg0.replace(FUSED_POINTNET=request.param, FUSED_ADAM=request.param)
    tree0 = _tree(state)
    with pltpu.force_tpu_interpret_mode():
        jax_one, jax_three, jax_metrics = _jax_run(cfg, mods, state, data)

    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    pcfg = Config.from_dict(cfg.to_dict())  # the same fields, the port's Config
    # one step
    pmods, pstate = build_pcaa(pcfg, VARIANTS[VARIATION.V4], device="cpu")
    pcaa_state_from_jax(tree0, pmods, pstate)
    idx = torch.from_numpy(data["perm"][0]).long()
    step = make_train_step(pmods, pcfg)
    pstate, m1 = step(pstate, x[idx], y[idx], 0,
                      (torch.from_numpy(data["z0"][0]), torch.from_numpy(data["alphas"][0])))
    port_one = pcaa_state_to_jax(pmods, pstate)
    # an epoch of three
    pmods, pstate = build_pcaa(pcfg, VARIANTS[VARIATION.V4], device="cpu")
    pcaa_state_from_jax(tree0, pmods, pstate)
    train_epoch, _ = make_epoch_fns(pmods, pcfg)
    pstate, m3 = train_epoch(pstate, x, y, data["perm"],
                             (torch.from_numpy(data["z0"]), torch.from_numpy(data["alphas"])))
    port_three = pcaa_state_to_jax(pmods, pstate)
    return dict(cfg=cfg, jax_one=jax_one, jax_three=jax_three, jax_metrics=jax_metrics,
                port_one=port_one, port_three=port_three, m1=m1, m3=m3)


def test_losses_match_step_by_step(runs):
    for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss", "n_correct"):
        want = np.array([float(m[key]) for m in runs["jax_metrics"]])
        np.testing.assert_allclose(float(runs["m1"][key]), want[0], **LOSS_TOL, err_msg=key)
        np.testing.assert_allclose(runs["m3"][key].numpy(), want, **LOSS_TOL, err_msg=key)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_moments(got, want, scale, noise):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        if _zero_grad(path):
            assert max(np.abs(g).max(), np.abs(w).max()) < noise, path
            continue
        atol = 1e-4 * scale * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-3 * scale, atol=atol, err_msg=str(path))


def _assert_params(got, want, steps, lr):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        diff = np.abs(np.asarray(g) - np.asarray(w))
        assert diff.max() <= 2 * lr * steps * 1.01, (path, diff.max())
        if not _zero_grad(path):
            assert np.mean(diff > 1e-6) < 0.01, (path, np.mean(diff > 1e-6))


@pytest.mark.parametrize("steps", [1, STEPS], ids=["one_step", "three_steps"])
def test_state_matches(runs, steps):
    got = runs["port_one" if steps == 1 else "port_three"]
    want = runs["jax_one" if steps == 1 else "jax_three"]
    lr = runs["cfg"].LR
    for side in ("opt_g", "opt_d"):
        assert int(got[side]["count"]) == int(want[side]["count"]) == steps
        _assert_moments(got[side]["mu"], want[side]["mu"], scale=steps, noise=1e-6)
        _assert_moments(got[side]["nu"], want[side]["nu"], scale=2 * steps, noise=1e-12)
    _assert_params(got["params_g"], want["params_g"], steps, lr)
    _assert_params(got["params_d"], want["params_d"], steps, lr)
    for (path, g), (_, w) in zip(_leaves(got["batch_stats"]), _leaves(want["batch_stats"])):
        atol = STATS_TOL["atol"]
        if getattr(path[-1], "key", None) == "mean":
            atol += 0.1 * lr * steps * (steps - 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=STATS_TOL["rtol"], atol=atol,
                                   err_msg=str(path))


def test_state_round_trips_through_the_port(start):
    _, _, state, _ = start
    tree = _tree(state)
    cfg = Config(MODEL_NAME="PORT_V4", **DIMS)
    mods, pstate = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
    pcaa_state_from_jax(tree, mods, pstate)
    back = pcaa_state_to_jax(mods, pstate)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)],
                         ids=["shuffled", "in_order", "padded"])
def test_epoch_batch_indices_equal_the_jax_package(shuffle, drop_last):
    """The same numpy Generator stream gives the same batches, epoch after epoch."""
    rngs = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        got = epoch_batch_indices(43, 8, shuffle, rngs[0], drop_last)
        want = jax_epoch_batch_indices(43, 8, shuffle, rngs[1], drop_last)
        np.testing.assert_array_equal(got, want)


# --- train_pcaa and the run folder -------------------------------------------

@pytest.fixture(scope="module")
def trained(generated_splits, tmp_path_factory):
    """A port-trained run folder: 2 epochs on a tenth of the generated
    train and valid splits (8 steps an epoch), read from disk."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("torch_train")
    cfg = Config(GEN_DATA_PATH=gen, MODELS_PATH=str(root / "models"), MODEL_NAME="PORT_V4",
                 EPOCHS=2, CHECKPOINT_FREQUENCY=1, SUBSAMPLE_FACTOR=0.1, **DIMS)
    out = train_pcaa(cfg, VARIATION.V4, verbose=False, device="cpu")
    return cfg, out, root


def test_run_folder_contract(trained, start):
    cfg, out, _ = trained
    for k, v in out.items():
        assert np.isfinite(v), (k, v)
    run_dir = cfg.run_dir()
    name = cfg.MODEL_NAME
    files = set(os.listdir(run_dir))
    assert {"config.json", "metrics.jsonl", "discriminator_means.npy", "run_complete.json",
            f"{name}_E.msgpack", f"{name}_D.msgpack", f"{name}_G.msgpack",
            f"{name}_GPH.msgpack"} == files
    assert Config.load(os.path.join(run_dir, "config.json")) == cfg
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["_step"] for r in lines] == [0, 1]
    assert {"Reconstruction Loss Train", "Reconstruction Loss Valid", "Cross Entropy Loss Train",
            "Cross Entropy Loss Valid", "Discriminator Loss", "Total Loss Train",
            "Train Accuracy", "Valid Accuracy"} <= set(lines[0])
    assert run_completed(run_dir)
    with open(os.path.join(run_dir, "run_complete.json")) as f:
        assert json.load(f).keys() == out.keys()
    # the files load in the JAX package, with the trees its build_pcaa makes
    jstate = start[2]
    expect = {
        "E": {"params": jstate.params_g["encoder"], "batch_stats": jstate.batch_stats["encoder"]},
        "D": {"params": jstate.params_d["discriminator"]},
        "G": {"params": jstate.params_g["decoder"]},
        "GPH": {"params": jstate.params_g["dec_head"]},
    }
    for tag, tree in expect.items():
        got = jax_load_params(os.path.join(run_dir, f"{name}_{tag}.msgpack"))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree), tag
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
            assert np.shape(g) == np.shape(w) and np.isfinite(g).all(), tag
    np.testing.assert_array_equal(
        np.load(os.path.join(run_dir, "discriminator_means.npy")), np.asarray(jstate.centroids)
    )


def test_port_trained_run_folder_scores_in_jax(trained):
    """JAX ``pcaa_inference`` scores the port's run folder; the port scores
    it too, and the crops' scores agree within atol 1e-4 (the encoders'
    f32 difference)."""
    cfg, _, root = trained
    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(root / side)
        shutil.copytree(cfg.run_dir(), os.path.join(paths[side], cfg.MODEL_NAME))
    common = dict(generate_dataset=False, dump_calibration=True)
    jax_logs = jax_pcaa_inference([cfg.MODEL_NAME], ks=[1], models_path=paths["jax"],
                                  figures_path=str(root / "fig_jax"), **common)
    pcaa_inference([cfg.MODEL_NAME], ks=[1], models_path=paths["port"],
                   figures_path=str(root / "fig_port"), device="cpu", **common)
    assert np.isfinite(jax_logs[cfg.MODEL_NAME][1]["f1_micro"])
    n_test = len(RadarCropDataset(SPLIT.TEST, cfg.GEN_DATA_PATH))
    want = np.load(os.path.join(paths["jax"], cfg.MODEL_NAME, "calibration.npz"))
    got = np.load(os.path.join(paths["port"], cfg.MODEL_NAME, "calibration.npz"))
    assert len(want["test_ll"]) == n_test
    for key in ("test_ll", "unseen_ll"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "variation,overrides,kwargs,error,match",
    [
        # the three options train since they were ported; JAX build_pcaa's refusals remain
        (VARIATION.V4, {"FACTORED_ADAM_NU": True, "FUSED_ADAM": True}, {}, ValueError,
         "FACTORED_ADAM_NU and FUSED_ADAM are exclusive"),
        (VARIATION.V4, {"DEFERRED_DECODER_UPDATE": True, "FUSED_ADAM": True}, {}, ValueError,
         "DEFERRED_DECODER_UPDATE recomputes the write.*fused kernel"),
        (VARIATION.V4, {"BF16_WEIGHT_CACHE": True}, {}, ValueError,
         "under f32 compute it would CHANGE numerics"),
        # ported: a run over 2 ranks needs them started (parallel/mesh.py::launch)
        (VARIATION.V4, {"DP_DEVICES": 2}, {}, RuntimeError, "one process per rank.*launch"),
    ],
    ids=["factored_nu", "deferred", "bf16_cache", "data_parallel"],
)
def test_unported_options_raise(tmp_path, variation, overrides, kwargs, error, match):
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_V4", EPOCHS=1, **{**DIMS, **overrides})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, cfg.NSTEPS, cfg.NMAX, 4)).astype(np.float32)
    y = np.zeros(8, np.int32)
    with pytest.raises(error, match=match):
        train_pcaa(cfg, variation, datasets=(x, y, x, y), verbose=False, device="cpu", **kwargs)
    assert not os.path.exists(cfg.run_dir())  # refused before anything is written


@pytest.mark.parametrize(
    "variation,overrides,kwargs,tags",
    [
        (VARIATION.V1, {}, {}, ("E", "D", "G", "GPH", "ML")),
        (VARIATION.V2, {}, {}, ("E", "D", "G")),
        (VARIATION.BASE, {}, {}, ("E", "D", "G")),
        (VARIATION.V3, {}, {}, ("E", "D")),
        (VARIATION.V4, {}, {"proj_head_on_discriminator": True}, ("E", "D", "G", "GPH", "DPH")),
        (VARIATION.V4, {"SAVE_RESUME_STATE": True}, {}, ("E", "D", "G", "GPH")),
        (VARIATION.V4, {"FACTORED_ADAM_NU": True}, {}, ("E", "D", "G", "GPH")),
        (VARIATION.V4, {"DEFERRED_DECODER_UPDATE": True}, {}, ("E", "D", "G", "GPH")),
        (VARIATION.V4, {"COMPUTE_DTYPE": "bfloat16", "BF16_WEIGHT_CACHE": True}, {},
         ("E", "D", "G", "GPH")),
    ],
    ids=["V1", "V2", "BASE", "V3", "disc_head", "save_resume", "factored_nu", "deferred",
         "bf16_cache"],
)
def test_formerly_unported_options_train(tmp_path, variation, overrides, kwargs, tags):
    """The options that raised before the variants, the resume state and the
    training options (factored Adam, the deferred decoder write, the bf16
    weight cache) were ported now train, and write the variant's run
    folder."""
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME=f"X_{variation.value}", EPOCHS=1,
                 **{**DIMS, **overrides})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, cfg.NSTEPS, cfg.NMAX, 4)).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 3
    out = train_pcaa(cfg, variation, datasets=(x, y, x, y), verbose=False, device="cpu",
                     **kwargs)
    assert all(np.isfinite(v) for v in out.values()), out
    resume = ({"train_state.msgpack", "train_state.msgpack.meta.json"}
              | ({"train_state.msgpack.best"} if out["best_valid_accuracy"] > 0 else set())
              if cfg.SAVE_RESUME_STATE else set())
    assert set(os.listdir(cfg.run_dir())) == {
        "config.json", "metrics.jsonl", "discriminator_means.npy", "run_complete.json",
    } | {f"{cfg.MODEL_NAME}_{tag}.msgpack" for tag in tags} | resume


def test_wandb_mode_writes_jsonl_without_wandb(tmp_path, monkeypatch):
    """A wandb mode trains where wandb cannot be imported (the card's
    machine has none), logging to metrics.jsonl alone, as the JAX package's
    logger does."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_V4", EPOCHS=1, **DIMS)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, cfg.NSTEPS, cfg.NMAX, 4)).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 3
    out = train_pcaa(cfg, VARIATION.V4, datasets=(x, y, x, y), verbose=False, device="cpu",
                     wandb_mode="offline")
    with open(os.path.join(cfg.run_dir(), "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["_step"] for r in lines] == [0]
    assert lines[0]["Train Accuracy"] == out["Train Accuracy"]


def test_existing_resume_state_raises(tmp_path):
    """A ``train_state.msgpack`` that the port did not write (no tagged
    ``.meta.json``) raises, naming the file, rather than being ignored."""
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_V4", **DIMS)
    os.makedirs(cfg.run_dir())
    open(os.path.join(cfg.run_dir(), "train_state.msgpack"), "wb").close()
    with pytest.raises(ValueError, match="X_V4/train_state.msgpack"):
        train_pcaa(cfg, VARIATION.V4, verbose=False, device="cpu")
