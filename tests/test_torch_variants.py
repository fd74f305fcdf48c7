"""The port's PCAA ablation variants against the JAX package's, on the CPU.

For each of V1, V2, BASE, V3 and V4 with the discriminator projection head
(DPH), one JAX ``build_pcaa`` state at ``tests/test_torch_train.py``'s
dims is carried into the port with ``convert.pcaa_state_from_jax``; both
sides then take the same three batches and the same injected noise ``(z0,
alphas)`` (``SUPERVISION_FREQUENCY=2``), with ``FUSED_POINTNET`` and
``FUSED_ADAM`` off. V2 and V3 run once more with both on (the JAX
package's Pallas kernels in interpret mode): V2/V3 take the encoder
without ``MLP_head``, and V3 has no leaf large enough for the Adam kernel.
Losses, parameters, Adam moments and running statistics are held to the
tolerances that ``tests/test_torch_train.py`` states and justifies; V1's
frozen mean learner keeps its parameters bit for bit while its running
statistics move, and the DPH stays at its init on both sides.

V1's checkpoint: from the same state, the port's ``_checkpoint`` writes
the JAX package's module files byte for byte (the ML file holds the
running statistics from before the learned-means call, which runs
train-mode BatchNorm) and ``discriminator_means.npy`` within rtol 1e-5,
atol 1e-6 (four f32 dense layers and a BatchNorm over 3 rows, summed in
other orders). Each variant's checkpoint writes the JAX package's file
set. A port-trained V1, V2 and V3 folder each scores in both packages'
``pcaa_inference`` with equal decisions, outside the windows that hold a
crop within 1e-4 of the threshold (the two encoders' f32 difference).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.infer.pcaa import pcaa_inference as jax_pcaa_inference
from opensetgaitrecognition_pcaa_tpu.train.optim import ScaleByAdamLowmemState, adam_lowmem
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    _checkpoint as jax_checkpoint,
    _ckpt_payload as jax_ckpt_payload,
    build_pcaa as jax_build_pcaa,
    make_train_step as jax_make_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import pcaa_state_from_jax, pcaa_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    _checkpoint,
    _ckpt_payload,
    build_pcaa,
    make_train_step,
    train_pcaa,
)

from tests.test_torch_train import (
    DIMS,
    LOSS_TOL,
    STATS_TOL,
    STEPS,
    _assert_moments,
    _assert_params,
    _leaves,
)

# case → (variant, DPH, kernel flags on)
CASES = {
    "V1": (VARIATION.V1, False, False),
    "V2": (VARIATION.V2, False, False),
    "BASE": (VARIATION.BASE, False, False),
    "V3": (VARIATION.V3, False, False),
    "V4_dph": (VARIATION.V4, True, False),
    "V2_fused": (VARIATION.V2, False, True),
    "V3_fused": (VARIATION.V3, False, True),
}
UNFUSED = [c for c in CASES if not CASES[c][2]]
MEANS_TOL = dict(rtol=1e-5, atol=1e-6)
KNIFE_EDGE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny: one intra-op thread per process keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(case):
    variation, dph, _ = CASES[case]
    jspec = JAX_VARIANTS[JAX_VARIATION(variation.value)]
    pspec = VARIANTS[variation]
    if dph:
        jspec = dataclasses.replace(jspec, use_disc_head=True)
        pspec = dataclasses.replace(pspec, use_disc_head=True)
    return jspec, pspec


def _tree(state):
    """The JAX state's pieces that the port carries, as numpy."""
    def opt(o):
        return {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}

    tree = {
        "params_g": state.params_g, "params_d": state.params_d,
        "batch_stats": state.batch_stats, "opt_g": opt(state.opt_g),
        "opt_d": opt(state.opt_d), "centroids": state.centroids,
    }
    if state.ml_params:
        tree["ml_params"] = state.ml_params
    return jax.device_get(tree)


def _data(cfg):
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    return dict(
        x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
        y=rng.integers(0, cfg.n_classes, n).astype(np.int32),
        perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32),
        z0=rng.normal(size=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)).astype(np.float32),
        alphas=rng.uniform(size=(STEPS, cfg.BATCH_SIZE, 1)).astype(np.float32),
    )


def _run(case):
    """One case: JAX and port, 3 steps each from the same state."""
    variation, _, fused = CASES[case]
    cfg = JaxConfig(MODEL_NAME=f"PORT_{variation.value}", SUPERVISION_FREQUENCY=2,
                    FUSED_POINTNET=fused, FUSED_ADAM=fused, **DIMS)
    jspec, pspec = _specs(case)
    mods, state = jax_build_pcaa(cfg, jspec, jax.random.PRNGKey(0))
    tree0 = _tree(state)
    data = _data(cfg)
    if fused:  # adam_lowmem's state layout, as build_pcaa makes it for FUSED_ADAM
        mods = dataclasses.replace(mods, tx_g=adam_lowmem(cfg.LR, b1=cfg.B1, b2=cfg.B2),
                                   tx_d=adam_lowmem(cfg.LR, b1=cfg.B1, b2=cfg.B2))
        state = state.replace(**{
            k: (ScaleByAdamLowmemState(*getattr(state, k)[0]),) + tuple(getattr(state, k)[1:])
            for k in ("opt_g", "opt_d")
        })
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_metrics = []
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jax_make_train_step(mods, cfg))
        for i in range(STEPS):
            idx = data["perm"][i]
            state, m = step(state, x[idx], y[idx], jnp.int32(i),
                            (jnp.asarray(data["z0"][i]), jnp.asarray(data["alphas"][i])))
            jax_metrics.append(jax.device_get(m))

    pcfg = Config.from_dict(cfg.to_dict())
    pmods, pstate = build_pcaa(pcfg, pspec, device="cpu")
    pcaa_state_from_jax(tree0, pmods, pstate)
    pstep = make_train_step(pmods, pcfg)
    px, py = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    port_metrics = []
    for i in range(STEPS):
        idx = torch.from_numpy(data["perm"][i]).long()
        pstate, m = pstep(pstate, px[idx], py[idx], i,
                          (torch.from_numpy(data["z0"][i]), torch.from_numpy(data["alphas"][i])))
        port_metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, pcfg=pcfg, pspec=pspec, jax_mods=mods, jax_state=state, tree0=tree0,
                jax_tree=_tree(state), jax_metrics=jax_metrics,
                port_tree=pcaa_state_to_jax(pmods, pstate), port_metrics=port_metrics)


class _Runs(dict):
    def __missing__(self, case):
        self[case] = _run(case)
        return self[case]


@pytest.fixture(scope="module")
def runs():
    """Each case runs once, the first time a test asks for it."""
    return _Runs()


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_step_by_step(runs, case):
    r = runs[case]
    for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss", "n_correct"):
        want = np.array([float(m[key]) for m in r["jax_metrics"]])
        got = np.array([m[key] for m in r["port_metrics"]])
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want, **LOSS_TOL, err_msg=key)
    if CASES[case][0] == VARIATION.V3:
        assert all(m["rec_loss"] == 0.0 for m in r["port_metrics"])


@pytest.mark.parametrize("case", list(CASES))
def test_state_matches(runs, case):
    r = runs[case]
    got, want = r["port_tree"], r["jax_tree"]
    assert set(got) == set(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    lr = r["cfg"].LR
    for side in ("opt_g", "opt_d"):
        assert int(got[side]["count"]) == int(want[side]["count"]) == STEPS
        _assert_moments(got[side]["mu"], want[side]["mu"], scale=STEPS, noise=1e-6)
        _assert_moments(got[side]["nu"], want[side]["nu"], scale=2 * STEPS, noise=1e-12)
    _assert_params(got["params_g"], want["params_g"], STEPS, lr)
    _assert_params(got["params_d"], want["params_d"], STEPS, lr)
    for (path, g), (_, w) in zip(_leaves(got["batch_stats"]), _leaves(want["batch_stats"])):
        atol = STATS_TOL["atol"]
        if getattr(path[-1], "key", None) == "mean":
            atol += 0.1 * lr * STEPS * (STEPS - 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=STATS_TOL["rtol"], atol=atol,
                                   err_msg=str(path))
    # the variant's pieces, and nothing more, on both sides
    variation, dph, _ = CASES[case]
    spec = VARIANTS[variation]
    assert set(got["params_g"]) == {"encoder"} | {
        k for k, on in (("dec_head", spec.use_dec_head), ("decoder", spec.use_decoder)) if on}
    assert set(got["params_d"]) == {"discriminator"} | ({"disc_head"} if dph else set())


def test_v1_mean_learner_is_frozen_while_its_statistics_move(runs):
    r = runs["V1"]
    for side in ("port_tree", "jax_tree"):
        for g, w in zip(jax.tree_util.tree_leaves(r[side]["ml_params"]),
                        jax.tree_util.tree_leaves(r["tree0"]["ml_params"])):
            np.testing.assert_array_equal(g, w)
    moved = [np.abs(np.asarray(g) - np.asarray(w)).max() for g, w in zip(
        jax.tree_util.tree_leaves(r["port_tree"]["batch_stats"]["mean_learner"]),
        jax.tree_util.tree_leaves(r["tree0"]["batch_stats"]["mean_learner"]))]
    assert min(moved) > 0, moved


def test_disc_head_stays_at_its_init(runs):
    r = runs["V4_dph"]
    for side in ("port_tree", "jax_tree"):
        tree = r[side]
        for g, w in zip(jax.tree_util.tree_leaves(tree["params_d"]["disc_head"]),
                        jax.tree_util.tree_leaves(r["tree0"]["params_d"]["disc_head"])):
            np.testing.assert_array_equal(g, w)
        assert int(tree["opt_d"]["count"]) == STEPS
        for key in ("mu", "nu"):
            for leaf in jax.tree_util.tree_leaves(tree["opt_d"][key]["disc_head"]):
                assert not np.asarray(leaf).any(), (side, key)


def _port_checkpoint(r, run_dir):
    """The port's ``_checkpoint`` of the JAX state after the 3 steps."""
    mods, state = build_pcaa(r["pcfg"], r["pspec"], device="cpu")
    pcaa_state_from_jax(r["jax_tree"], mods, state)
    before = {k: v.clone() for k, v in mods.state_dict().items()}
    name = r["cfg"].MODEL_NAME
    _checkpoint(run_dir, name, mods, _ckpt_payload(mods))
    for k, v in mods.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("case", UNFUSED)
def test_checkpoint_files_equal_the_jax_package_s(runs, case, tmp_path):
    r = runs[case]
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    jax_checkpoint(dirs["jax"], r["cfg"].MODEL_NAME, r["jax_mods"],
                   jax_ckpt_payload(r["jax_state"]), r["cfg"])
    _port_checkpoint(r, dirs["port"])
    files = sorted(os.listdir(dirs["port"]))
    assert files == sorted(os.listdir(dirs["jax"]))
    tags = {f.rsplit("_", 1)[-1].split(".")[0] for f in files if f.endswith(".msgpack")}
    want = {"E", "D"} | {
        "V1": {"G", "GPH", "ML"}, "V2": {"G"}, "BASE": {"G"}, "V3": set(),
        "V4_dph": {"G", "GPH", "DPH"}}[case]
    assert tags == want
    assert ("discriminator_means.npy" in files) == (case == "V1")
    for f in files:
        path = {side: os.path.join(d, f) for side, d in dirs.items()}
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(path["port"]), np.load(path["jax"]), **MEANS_TOL)
            continue
        with open(path["port"], "rb") as a, open(path["jax"], "rb") as b:
            assert a.read() == b.read(), f


# --- port-trained V1, V2 and V3 run folders, scored by both packages --------

@pytest.fixture(scope="module")
def trained(generated_splits, tmp_path_factory):
    """Port-trained run folders, 1 epoch on a tenth of the generated train
    and valid splits; each scored by the JAX and the port ``pcaa_inference``."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("torch_variants")
    out = {}
    for variation in (VARIATION.V1, VARIATION.V2, VARIATION.V3):
        name = f"PORT_{variation.value}"  # inference reads the variant from the name
        cfg = Config(GEN_DATA_PATH=gen, MODELS_PATH=str(root / "models"), MODEL_NAME=name,
                     EPOCHS=1, SUBSAMPLE_FACTOR=0.1, **DIMS)
        train_pcaa(cfg, variation, verbose=False, device="cpu")
        files = set(os.listdir(cfg.run_dir()))
        paths = {}
        for side in ("jax", "port"):
            paths[side] = str(root / side)
            shutil.copytree(cfg.run_dir(), os.path.join(paths[side], name))
        common = dict(ks=[1, 2], generate_dataset=False, dump_calibration=True)
        jax_pcaa_inference([name], models_path=paths["jax"],
                           figures_path=str(root / "fig_jax"), **common)
        pcaa_inference([name], models_path=paths["port"],
                       figures_path=str(root / "fig_port"), device="cpu", **common)
        out[variation] = dict(cfg=cfg, files=files, paths=paths)
    return out


def _window_starts(labels, k, keep=None):
    return [s for s in range(0, len(labels) - k + 1, k)
            if len(np.unique(labels[s:s + k])) == 1 and (keep is None or keep[s])]


@pytest.mark.parametrize("variation", [VARIATION.V1, VARIATION.V2, VARIATION.V3],
                         ids=["V1", "V2", "V3"])
def test_port_trained_folder_scores_equal_in_both_packages(trained, variation):
    t = trained[variation]
    name = t["cfg"].MODEL_NAME
    tags = {"V1": ("E", "D", "G", "GPH", "ML"), "V2": ("E", "D", "G"), "V3": ("E", "D")}
    assert t["files"] == {"config.json", "metrics.jsonl", "discriminator_means.npy",
                          "run_complete.json"} | {f"{name}_{tag}.msgpack"
                                                  for tag in tags[variation.value]}
    cal = {side: dict(np.load(os.path.join(p, name, "calibration.npz")))
           for side, p in t["paths"].items()}
    for key in ("test_ll", "unseen_ll"):
        assert np.isfinite(cal["port"][key]).all()
        np.testing.assert_allclose(cal["port"][key], cal["jax"][key], rtol=0, atol=KNIFE_EDGE)
    for key in ("test_labels", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(cal["port"][key], cal["jax"][key])
    thr = float(cal["jax"]["log_threshold"])
    edge = {split: np.abs(cal["jax"][f"{split}_ll"] - thr) <= KNIFE_EDGE
            for split in ("test", "unseen")}
    labels = cal["jax"]
    for k in (1, 2):
        exempt = [edge["test"][s:s + k].any() for s in _window_starts(labels["test_labels"], k)]
        exempt += [edge["unseen"][s:s + k].any() for s in
                   _window_starts(labels["unseen_labels"], k, ~labels["is_val"])]
        exempt = np.array(exempt, bool)
        for stem in ("final_preds", "final_labels"):
            got = np.load(os.path.join(t["paths"]["port"], name, f"{stem}_{k}.npy"))
            want = np.load(os.path.join(t["paths"]["jax"], name, f"{stem}_{k}.npy"))
            assert got.shape == want.shape == exempt.shape and len(got) > 0
            assert not ((got != want) & ~exempt).any(), (stem, k)
