"""The slice end to end: the port's V4 open-set inference against the JAX
package's on one run folder, on the CPU.

The run folder comes from a flax init (parameters perturbed, running
statistics moved by 30 train-mode applies), saved by the JAX package. Each
side runs ``pcaa_inference`` on its own copy. The windows' decisions and
the metrics must be equal; the seed is fixed so that no crop's score lies
within 1e-3 of the threshold, which the test asserts, so that the f32
difference between the two encoders (about 1e-6) cannot flip a decision.
"""

import json
import os
import shutil

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import SPLIT as JAX_SPLIT, Config
from opensetgaitrecognition_pcaa_tpu.data.dataset import RadarCropDataset as JaxDataset
from opensetgaitrecognition_pcaa_tpu.data.splits import generate_splits as jax_generate_splits
from opensetgaitrecognition_pcaa_tpu.infer.pcaa import pcaa_inference as jax_pcaa_inference
from opensetgaitrecognition_pcaa_tpu.models import CGEncoder as FlaxCGEncoder
from opensetgaitrecognition_pcaa_tpu.train.run_folder import module_path, save_params

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, Config as PortConfig
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from opensetgaitrecognition_pcaa_tpu_torch.infer.artifacts import openset_confusion_matrix
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
    OpenSetCalibration,
    _window_vote,
    naive_sequential_procedure,
    pcaa_inference,
    pcaa_inference_setup,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import make_pcaa_decision_fn

from tests.test_torch_splits import assert_splits_equal
from tests.test_torch_models import flax_encoder_vars

NAME = "PORT_V4"
KS = (1, 2)
DIMS = dict(POINTNET_OUT_DIM=32, DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=32)
SEED = 4


@pytest.fixture(scope="module")
def runs(generated_splits, tmp_path_factory):
    """→ (cfg, jax models_path, port models_path), inference run on both."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("torch_infer")
    cfg = Config(
        GEN_DATA_PATH=gen, MODEL_NAME=NAME, TRAIN_CLASSES=(0, 1, 2),
        NMAX=64, NSTEPS=12, CROP_STEP=4, **DIMS,
    )
    x, _ = JaxDataset(JAX_SPLIT.TRAIN, gen).load_all()
    enc = FlaxCGEncoder(
        n_out_labels=3, sup_latent_dim=cfg.SUP_LATENT_DIM,
        pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=cfg.DTC_FILTERS,
        use_projection_head=True,
    )
    # 30 train-mode applies bring the running statistics near the batch's,
    # so the latents spread across crops
    enc_vars = flax_encoder_vars(enc, x[:16], seed=SEED, steps=30)
    run_dir = str(root / "src" / NAME)
    cfg.save(os.path.join(run_dir, "config.json"))
    save_params(enc_vars, module_path(run_dir, NAME, "E"))
    means = np.random.default_rng(SEED).normal(0, 0.3, (3, cfg.SUP_LATENT_DIM))
    np.save(os.path.join(run_dir, "discriminator_means.npy"), means.astype(np.float32))

    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(root / side)
        shutil.copytree(run_dir, os.path.join(paths[side], NAME))
    common = dict(generate_dataset=False, dump_calibration=True)
    jax_pcaa_inference(
        [NAME], ks=KS, models_path=paths["jax"],
        figures_path=str(root / "fig_jax"), **common,
    )
    pcaa_inference(
        [NAME], ks=KS, models_path=paths["port"],
        figures_path=str(root / "fig_port"), device="cpu", **common,
    )
    return cfg, paths["jax"], paths["port"]


def _calibration(models_path):
    return np.load(os.path.join(models_path, NAME, "calibration.npz"))


def test_scores_are_clear_of_the_threshold(runs):
    _, jax_path, port_path = runs
    want, got = _calibration(jax_path), _calibration(port_path)
    thr = float(want["log_threshold"])
    scores = np.concatenate([want["test_ll"], want["unseen_ll"]])
    others = scores[scores != thr]  # the threshold is itself a crop's score
    assert np.isfinite(thr) and np.abs(others - thr).min() > 1e-3
    np.testing.assert_allclose(float(got["log_threshold"]), thr, rtol=0, atol=1e-4)
    for key in ("test_ll", "unseen_ll"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
    for key in ("test_preds", "test_labels", "unseen_preds", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("k", KS)
def test_decisions_and_metrics_equal(runs, k):
    _, jax_path, port_path = runs
    for stem in (f"final_preds_{k}.npy", f"final_labels_{k}.npy"):
        want = np.load(os.path.join(jax_path, NAME, stem))
        got = np.load(os.path.join(port_path, NAME, stem))
        assert got.dtype == want.dtype and len(got) > 0
        np.testing.assert_array_equal(got, want)
    for stem in (f"naive_seq_log_{k}.json", "naive_seq_log_subsampled0.json"):
        with open(os.path.join(jax_path, NAME, stem)) as f:
            want = json.load(f)
        with open(os.path.join(port_path, NAME, stem)) as f:
            assert json.load(f) == want


def test_generate_dataset_writes_the_jax_splits(runs, tmp_path):
    """``generate_dataset=True`` (the default) rewrites the run's splits
    from the raw tracks, at the run's NMAX, NSTEPS and CROP_STEP, seed 0
    and 10 subjects, as the JAX setup does: the same files, bit-equal.
    ``data_path`` overrides the run's ``DATA_PATH`` and
    ``force_pc_subsampling`` reaches the points."""
    _, _, port_path = runs
    raw = str(tmp_path / "raw")
    generate_synthetic_raw_dataset(raw, n_subjects=10, tracks_per_scenario=10,
                                   frames_per_track=(20, 30), seed=11)
    models = str(tmp_path / "models")
    shutil.copytree(os.path.join(port_path, NAME), os.path.join(models, NAME))
    config_path = os.path.join(models, NAME, "config.json")
    cfg = PortConfig.load(config_path).replace(GEN_DATA_PATH=str(tmp_path / "gen_port"),
                                               DATA_PATH=str(tmp_path / "absent"))
    cfg.save(config_path)
    got_cfg, encoder, _ = pcaa_inference_setup(NAME, VARIATION.V4, device="cpu",
                                               models_path=models, data_path=raw,
                                               force_pc_subsampling=20)
    assert got_cfg == cfg and not encoder.training
    jax_generate_splits(data_path=raw, gen_data_path=str(tmp_path / "gen_jax"),
                        train_classes=cfg.TRAIN_CLASSES, seed=0, force_pc_subsampling=20,
                        nmax_points=cfg.NMAX, nsteps=cfg.NSTEPS, crop_step=cfg.CROP_STEP,
                        verbose=False)
    assert_splits_equal(str(tmp_path / "gen_port"), str(tmp_path / "gen_jax"))


def test_confusion_png_is_written(runs, tmp_path):
    """``pcaa_inference`` wrote the PNG of each k by default (the fixture),
    and ``naive_sequential_procedure`` writes the matrix of its decisions."""
    _, _, port_path = runs
    figures = os.path.join(os.path.dirname(port_path), "fig_port", NAME)
    for k in KS:
        assert os.path.getsize(os.path.join(figures,
                                            f"openset_confusion_matrix_naive_seq_{k}.png")) > 0
    cal = _calibration(port_path)
    fields = {k: cal[k] for k in OpenSetCalibration._fields}
    fields.update(log_threshold=float(cal["log_threshold"]), n_labels=int(cal["n_labels"]))
    _, preds, labels = naive_sequential_procedure(
        1, OpenSetCalibration(**fields), str(tmp_path),
        figures_folder=str(tmp_path), confusion_png=True,
    )
    path = tmp_path / "openset_confusion_matrix_naive_seq_1.png"
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    image = np.rint(mpimg.imread(str(path)) * 255).astype(np.int64)
    cm = openset_confusion_matrix(labels, preds, int(cal["n_labels"]))
    cell = image.shape[0] // cm.shape[0]
    steps = 255 - image[cell // 2::cell, cell // 2::cell, 0]  # the ramp's red is 255 - step
    np.testing.assert_allclose(steps / 255, cm, rtol=0, atol=1 / 255)


@pytest.mark.parametrize("k", KS)
def test_serving_matches_window_vote(runs, k):
    cfg, _, port_path = runs
    cal = _calibration(port_path)
    _, encoder, means = pcaa_inference_setup(
        NAME, VARIATION.V4, device="cpu", models_path=port_path, generate_dataset=False
    )
    ds = RadarCropDataset(SPLIT.TEST, cfg.GEN_DATA_PATH, sequential=True)
    x, labels = ds.load_all()
    starts = [
        s for s in range(0, len(x) - k + 1, k) if len(np.unique(labels[s:s + k])) == 1
    ][:12]
    idx = np.concatenate([np.arange(s, s + k) for s in starts])
    thr = float(cal["log_threshold"])
    want, _ = _window_vote(
        cal["test_ll"][idx], cal["test_preds"][idx], labels[idx], k, thr, int(cal["n_labels"])
    )
    decide = make_pcaa_decision_fn(encoder, int(cal["n_labels"]), k)
    windows = torch.from_numpy(x[idx].reshape((len(starts), k) + x.shape[1:]))
    decisions, n_above = decide(means, thr, windows)
    np.testing.assert_array_equal(decisions.numpy(), want)
    want_above = (cal["test_ll"][idx] > thr).reshape(len(starts), k).sum(1)
    np.testing.assert_array_equal(n_above.numpy(), want_above)
