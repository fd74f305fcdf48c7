"""The port's OR-CED training against the JAX package's, on the CPU.

One JAX ``build_orced`` state (tier-1 dims: NMAX 64, NSTEPS 12, PointNet
64, latent 16, B 8) is carried into the port with
``convert.orced_state_from_jax``. Both sides then take the same batches,
the same injected reparametrization draws ``eps`` and the KL weight 0.5:
one step, and an epoch of three. JAX's per-step key split cannot be
replayed, so the steps' parity rests on the injected eps.

Precondition: no pair of the embeddings the triplet miner sees lies within
1e-5 of a mining boundary (``sim < hardest_neg + 0.1`` or ``sim >
easiest_pos - 0.1``), so the two frameworks' f32 rounding of ``z @ z.T``
cannot flip a mined pair. The test asserts it rather than loosening a
tolerance.

Tolerances, with the reasons of ``tests/test_torch_train.py``:

- the five losses rtol 1e-4;
- Adam's moments: mu = (1 − b1)·g after one step holds the gradients,
  rtol 1e-3 with atol 1e-4 of the leaf's largest magnitude; nu = (1 −
  b1)·g² (the reference's ``betas=(B1, B1)``) doubled; both scaled by the
  number of steps. A dense or conv bias ahead of a train-mode BatchNorm
  (the PointNet, the TCN and the mean learner's first three layers) has a
  zero gradient: both sides hold f32 rounding noise of a sum over the
  layer's rows there, held instead to the atol of the layer's kernel,
  1e-4·scale of the kernel moment's largest magnitude;
- parameters within 2·lr per step, and outside those biases fewer than 1%
  of the weights more than 1e-6 apart;
- running statistics of the encoder and the mean learner rtol 1e-4, atol
  1e-6, the means 0.1·lr·s·(s − 1) more after s steps.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.infer import orced as jax_orced
from opensetgaitrecognition_pcaa_tpu.train.orced import (
    build_orced as jax_build_orced,
    make_orced_train_step as jax_make_orced_train_step,
)
from opensetgaitrecognition_pcaa_tpu.train.run_folder import load_params as jax_load_params

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import orced_state_from_jax, orced_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.infer import orced
from opensetgaitrecognition_pcaa_tpu_torch.ops import losses
from opensetgaitrecognition_pcaa_tpu_torch.train import orced as port_orced
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    RESUME_FORMAT,
    load_train_state,
    run_completed,
)

DIMS = dict(NMAX=64, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8)
STEPS = 3
KL_MULT = 0.5
LOSS_TOL = dict(rtol=1e-4, atol=0)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
MINING_MARGIN = 1e-5
METRIC_NAMES = {"Reconstruction Loss Train", "Reconstruction Loss Valid",
                "Cross Entropy Loss Train", "Cross Entropy Loss Valid", "Triplet Loss",
                "KL Loss", "Total Loss Train", "Train Accuracy", "Valid Accuracy"}


def _zero_grad(path) -> bool:
    """A dense or conv bias ahead of a train-mode BatchNorm."""
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


def _mining_gap(z: torch.Tensor, labels: torch.Tensor, epsilon: float = 0.1) -> float:
    """The smallest distance of a mined pair's similarity from its mining
    boundary (inf when no pair has a boundary)."""
    zn = z / torch.linalg.norm(z, dim=1, keepdim=True)
    sim = (zn @ zn.T).double()
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(z), dtype=torch.bool)
    pos, neg = same & ~eye, ~same
    hardest_neg = torch.where(neg, sim, -torch.inf).amax(1)
    easiest_pos = torch.where(pos, sim, torch.inf).amin(1)
    gaps = torch.cat([(sim - (hardest_neg[:, None] + epsilon))[pos],
                      (sim - (easiest_pos[:, None] - epsilon))[neg]]).abs()
    gaps = gaps[torch.isfinite(gaps)]
    return float(gaps.min()) if len(gaps) else float("inf")


@pytest.fixture(scope="module")
def start():
    """→ (JAX cfg, JAX modules, JAX state, data): one JAX build_orced state."""
    cfg = JaxConfig(MODEL_NAME="PORT_ORCED", **DIMS)
    models, state = jax_build_orced(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    data = dict(
        x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
        y=np.tile(np.arange(cfg.n_classes), n)[:n].astype(np.int32),
        perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32),
        eps=rng.normal(size=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)).astype(np.float32),
    )
    return cfg, models, state, data


@pytest.fixture(scope="module")
def runs(start):
    """JAX and port, from the same state: 1 step, then an epoch of 3."""
    cfg, models, state, data = start
    tree0 = _tree(state)
    step = jax.jit(jax_make_orced_train_step(models, cfg))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_trees, jax_metrics = [], []
    for i in range(STEPS):
        idx = data["perm"][i]
        state, m = step(state, x[idx], y[idx], jnp.int32(i), jnp.float32(KL_MULT),
                        eps=jnp.asarray(data["eps"][i]))
        jax_metrics.append(jax.device_get(m))
        jax_trees.append(_tree(state))

    pcfg = Config.from_dict(cfg.to_dict())
    xt, yt = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    seen = []

    def recording_triplet(z, labels, **kw):
        seen.append((z.detach().clone(), labels.clone()))
        return losses.triplet_loss_with_ms_miner(z, labels, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_orced, "triplet_loss_with_ms_miner", recording_triplet)
    try:
        mods, pstate = port_orced.build_orced(pcfg, device="cpu")
        orced_state_from_jax(tree0, mods, pstate)
        idx = torch.from_numpy(data["perm"][0]).long()
        pstate, m1 = port_orced.make_orced_train_step(mods, pcfg)(
            pstate, xt[idx], yt[idx], KL_MULT, torch.from_numpy(data["eps"][0]))
        port_one = orced_state_to_jax(mods, pstate)
        mods, pstate = port_orced.build_orced(pcfg, device="cpu")
        orced_state_from_jax(tree0, mods, pstate)
        train_epoch, _ = port_orced.make_orced_epoch_fns(mods, pcfg)
        pstate, m3 = train_epoch(pstate, xt, yt, data["perm"], KL_MULT,
                                 torch.from_numpy(data["eps"]))
        port_three = orced_state_to_jax(mods, pstate)
    finally:
        mp.undo()
    return dict(cfg=cfg, jax_one=jax_trees[0], jax_three=jax_trees[-1], jax_metrics=jax_metrics,
                port_one=port_one, port_three=port_three, m1=m1, m3=m3, seen=seen)


def test_mined_pairs_are_clear_of_the_boundaries(runs):
    assert len(runs["seen"]) == 1 + STEPS
    for z, labels in runs["seen"]:
        assert _mining_gap(z, labels) > MINING_MARGIN


def test_losses_match_step_by_step(runs):
    for key in ("rec_loss", "sup_loss", "trip_loss", "kl_loss", "tot_loss", "n_correct"):
        want = np.array([float(m[key]) for m in runs["jax_metrics"]])
        np.testing.assert_allclose(float(runs["m1"][key]), want[0], **LOSS_TOL, err_msg=key)
        np.testing.assert_allclose(runs["m3"][key].numpy(), want, **LOSS_TOL, err_msg=key)
    assert (np.array([float(m["trip_loss"]) for m in runs["jax_metrics"]]) > 0).all()


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("steps", [1, STEPS], ids=["one_step", "three_steps"])
def test_state_matches(runs, steps):
    got = runs["port_one" if steps == 1 else "port_three"]
    want = runs["jax_one" if steps == 1 else "jax_three"]
    lr = runs["cfg"].LR
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == steps
    for key, scale in (("mu", steps), ("nu", 2 * steps)):
        got_leaves, want_leaves = _leaves(got["opt"][key]), _leaves(want["opt"][key])
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            w = np.asarray(w)
            if _zero_grad(path):
                layer = want["opt"][key]
                for k in path[:-1]:
                    layer = layer[k.key]
                noise = 1e-4 * scale * float(np.abs(np.asarray(layer["kernel"])).max())
                assert max(np.abs(g).max(), np.abs(w).max()) < noise, path
                continue
            np.testing.assert_allclose(g, w, rtol=1e-3 * scale,
                                       atol=1e-4 * scale * float(np.abs(w).max()),
                                       err_msg=str(path))
    for (path, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        diff = np.abs(np.asarray(g) - np.asarray(w))
        assert diff.max() <= 2 * lr * steps * 1.01, (path, diff.max())
        if not _zero_grad(path):
            assert np.mean(diff > 1e-6) < 0.01, (path, np.mean(diff > 1e-6))
    stats = _leaves(got["batch_stats"])
    assert {getattr(p[0], "key", None) for p, _ in stats} == {"encoder", "mean_learner"}
    for (path, g), (_, w) in zip(stats, _leaves(want["batch_stats"])):
        atol = STATS_TOL["atol"]
        if getattr(path[-1], "key", None) == "mean":
            atol += 0.1 * lr * steps * (steps - 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=STATS_TOL["rtol"], atol=atol,
                                   err_msg=str(path))


def test_state_round_trips_through_the_port(start):
    _, _, state, _ = start
    tree = _tree(state)
    mods, pstate = port_orced.build_orced(Config(MODEL_NAME="PORT_ORCED", **DIMS), device="cpu")
    orced_state_from_jax(tree, mods, pstate)
    back = orced_state_to_jax(mods, pstate)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(g, np.asarray(w))


# --- train_orced and the run folder ------------------------------------------

@pytest.fixture(scope="module")
def trained(generated_splits, tmp_path_factory):
    """A port-trained ORCED run folder: 2 epochs on a tenth of the generated
    train and valid splits, read from disk."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("torch_orced_train")
    cfg = Config(GEN_DATA_PATH=gen, MODELS_PATH=str(root / "models"), MODEL_NAME="PORT_ORCED",
                 EPOCHS=2, CHECKPOINT_FREQUENCY=1, SUBSAMPLE_FACTOR=0.1, **DIMS)
    out = port_orced.train_orced(cfg, verbose=False, device="cpu")
    return cfg, out, root


def test_run_folder_contract(trained, start):
    cfg, out, _ = trained
    for k, v in out.items():
        assert np.isfinite(v), (k, v)
    run_dir, name = cfg.run_dir(), cfg.MODEL_NAME
    assert set(os.listdir(run_dir)) == {
        "config.json", "metrics.jsonl", "run_complete.json",
        f"{name}_E.msgpack", f"{name}_G.msgpack", f"{name}_ML.msgpack"}
    assert Config.load(os.path.join(run_dir, "config.json")) == cfg
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["_step"] for r in lines] == [0, 1]
    for line in lines:
        assert set(line) - {"_step", "_wall"} == METRIC_NAMES
    assert lines[0]["KL Loss"] == 0.0 and lines[1]["KL Loss"] != 0.0
    assert run_completed(run_dir)
    # the files load in the JAX package, with the trees its build_orced makes
    jstate = start[2]
    expect = {
        "E": {"params": jstate.params["encoder"], "batch_stats": jstate.batch_stats["encoder"]},
        "G": {"params": jstate.params["decoder"]},
        "ML": {"params": jstate.params["mean_learner"],
               "batch_stats": jstate.batch_stats["mean_learner"]},
    }
    for tag, tree in expect.items():
        got = jax_load_params(os.path.join(run_dir, f"{name}_{tag}.msgpack"))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree), tag
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
            assert np.shape(g) == np.shape(w) and np.isfinite(g).all(), tag


def test_port_trained_run_folder_scores_in_jax(trained):
    """JAX ``orced_inference`` scores the port-trained folder, and so does
    the port, with the same pinned eps: equal decisions except on knife
    edges, crops whose rec error lies within rtol 1e-4 of its threshold or
    whose latent score lies within 1e-4 of 0.95."""
    cfg, _, root = trained
    rng = np.random.default_rng(5)
    eps = {}
    # the crops each split keeps under the run's SUBSAMPLE_FACTOR, as both
    # packages' orced_inference draw them (seed 0 + the split's index)
    for i, (key, split) in enumerate((("train", SPLIT.TRAIN), ("test", SPLIT.TEST),
                                      ("unseen", SPLIT.UNSEEN))):
        n = len(RadarCropDataset(split, cfg.GEN_DATA_PATH, subsample_factor=cfg.SUBSAMPLE_FACTOR,
                                 subsample_rng=np.random.default_rng(i)))
        eps[key] = rng.normal(size=(n, cfg.SUP_LATENT_DIM)).astype(np.float32)
    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(root / side)
        shutil.copytree(cfg.run_dir(), os.path.join(paths[side], cfg.MODEL_NAME))
    common = dict(generate_dataset=False, batch_size=16, eps_streams=eps)
    jax_orced.orced_inference([cfg.MODEL_NAME], models_path=paths["jax"],
                              figures_path=str(root / "fig_jax"), **common)
    orced.orced_inference([cfg.MODEL_NAME], models_path=paths["port"],
                          figures_path=str(root / "fig_port"), device="cpu",
                          dump_calibration=True, **common)
    final = {}
    for side in ("jax", "port"):
        final[side] = {stem: np.load(os.path.join(root, f"fig_{side}", cfg.MODEL_NAME,
                                                  f"ensemble_ood_final_{stem}_fixed.npy"))
                       for stem in ("preds", "labels")}
    np.testing.assert_array_equal(final["port"]["labels"], final["jax"]["labels"])
    assert len(final["port"]["preds"]) > 0
    cal = dict(np.load(os.path.join(paths["port"], cfg.MODEL_NAME, "orced_calibration.npz")))
    stats = orced.ORCEDClassStats(cal["means_z"], cal["stds_z"], cal["thresholds_re"],
                                  int(cal["n_labels"]))
    keep = cal["unseen_keep"]
    preds = np.concatenate([cal["test_preds"], cal["unseen_preds"][keep]])
    z = np.concatenate([cal["test_z"], cal["unseen_z"][keep]])
    re = np.concatenate([cal["test_re"], cal["unseen_re"][keep]])
    thr = stats.thresholds_re[preds]
    edge = (np.abs(re - thr) <= 1e-4 * np.abs(thr)) | (
        np.abs(orced.orced_latent_scores(stats, z) - orced.THRESHOLD_G) <= 1e-4).any(0)
    bad = (final["port"]["preds"] != final["jax"]["preds"]) & ~edge
    assert not bad.any(), f"{int(bad.sum())} decisions differ away from the knife edge"
    assert os.path.exists(os.path.join(root, "fig_port", cfg.MODEL_NAME,
                                       "openset_cnfmtrx_ensemble_ood_fixed.png"))


@pytest.mark.parametrize(
    "overrides,error,match",
    [
        ({"FUSED_ADAM": True}, ValueError, "PCAA-only"),
        ({"DEFERRED_DECODER_UPDATE": True}, ValueError, "PCAA-only"),
        # FACTORED_ADAM_NU trains since it was ported; with FUSED_ADAM, JAX's refusal
        ({"FACTORED_ADAM_NU": True, "FUSED_ADAM": True}, ValueError, "FUSED_ADAM is PCAA-only"),
        # BF16_WEIGHT_CACHE is ported for bf16 compute; at f32 JAX build_orced refuses it
        ({"BF16_WEIGHT_CACHE": True}, ValueError, "would CHANGE numerics"),
        # ported: a run over 2 ranks needs them started (parallel/mesh.py::launch)
        ({"DP_DEVICES": 2}, RuntimeError, "one process per rank.*launch"),
    ],
    ids=["fused_adam", "deferred", "factored_nu", "bf16_cache", "data_parallel"],
)
def test_unported_options_raise(tmp_path, overrides, error, match):
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_ORCED", EPOCHS=1,
                 **{**DIMS, **overrides})
    x = np.zeros((8, cfg.NSTEPS, cfg.NMAX, 4), np.float32)
    y = np.zeros(8, np.int32)
    with pytest.raises(error, match=match):
        port_orced.train_orced(cfg, datasets=(x, y, x, y), verbose=False, device="cpu")


def test_save_resume_state_writes_the_port_state(tmp_path):
    """``SAVE_RESUME_STATE``, which raised before the resume state was
    ported, writes the port's tagged state beside the run folder."""
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_ORCED", EPOCHS=1,
                 SAVE_RESUME_STATE=True, CHECKPOINT_FREQUENCY=1, **DIMS)
    x = np.zeros((8, cfg.NSTEPS, cfg.NMAX, 4), np.float32)
    y = np.arange(8, dtype=np.int32) % 3
    port_orced.train_orced(cfg, datasets=(x, y, x, y), verbose=False, device="cpu")
    tree, next_epoch, meta = load_train_state(os.path.join(cfg.run_dir(), "train_state.msgpack"))
    assert next_epoch == 1 and meta["format"] == RESUME_FORMAT
    assert set(tree) == {"modules", "opt", "generator"}
    assert int(tree["opt"]["count"]) == 1


def test_existing_resume_state_raises(tmp_path):
    """A ``train_state.msgpack`` that the port did not write (no tagged
    ``.meta.json``) raises, naming the file, rather than being ignored."""
    cfg = Config(MODELS_PATH=str(tmp_path), MODEL_NAME="X_ORCED", EPOCHS=1, **DIMS)
    os.makedirs(cfg.run_dir())
    open(os.path.join(cfg.run_dir(), "train_state.msgpack"), "wb").close()
    x = np.zeros((8, cfg.NSTEPS, cfg.NMAX, 4), np.float32)
    y = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="X_ORCED/train_state.msgpack"):
        port_orced.train_orced(cfg, datasets=(x, y, x, y), verbose=False, device="cpu")
