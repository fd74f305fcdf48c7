"""The OR-CED slice end to end: the port's ``orced_inference`` and serving
against the JAX package's, on the CPU.

One ORCED run folder comes from flax inits (every parameter perturbed, the
running statistics moved by train-mode applies), saved by the JAX
package. Each side runs ``orced_inference`` on its own copy with the same
``eps_streams`` (the pinned reparametrization draws) and the same
``crop_order``, at ``batch_size=16``. The decisions, labels and
``ensemble_ood_log.json`` must be equal. The seed is fixed so that no
crop's rec error lies within rtol 1e-4 of its predicted class's
``μ + 2σ`` and no latent score within 1e-4 of 0.95, which the test
asserts: the f32 gap between the two encoders and Chamfers (about 1e-6)
cannot flip a decision. The per-crop arrays of the two sides agree within
rtol 1e-5, atol 1e-5 (f32 sums in other orders); the f64 criterion code is
the same numpy on both sides and is held to exact equality.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import SPLIT as JAX_SPLIT, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.data.dataset import RadarCropDataset as JaxDataset
from opensetgaitrecognition_pcaa_tpu.data.splits import generate_splits as jax_generate_splits
from opensetgaitrecognition_pcaa_tpu.infer import orced as jax_orced
from opensetgaitrecognition_pcaa_tpu.infer import serving as jax_serving
from opensetgaitrecognition_pcaa_tpu.models import (
    ORCEDDecoder as FlaxORCEDDecoder,
    ORCEDEncoder as FlaxORCEDEncoder,
)
from opensetgaitrecognition_pcaa_tpu.ops import openset as jax_openset
from opensetgaitrecognition_pcaa_tpu.train.run_folder import module_path, save_params

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config as PortConfig
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from opensetgaitrecognition_pcaa_tpu_torch.infer import orced
from opensetgaitrecognition_pcaa_tpu_torch.infer.artifacts import openset_confusion_matrix
from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import (
    make_orced_forward_fn,
    orced_decide_host,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops import openset

from tests.test_torch_splits import assert_splits_equal
from tests.test_torch_orced_models import (
    _perturbed,
    flax_mean_learner_vars,
    flax_orced_encoder_vars,
)

NAME = "PORT_ORCED"
DIMS = dict(POINTNET_OUT_DIM=32, DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=32)
SEED = 0
BATCH = 16
TOL = dict(rtol=1e-5, atol=1e-5)
RE_MARGIN = 1e-4  # relative distance of a rec error from its threshold
P_MARGIN = 1e-4  # distance of a latent score from 0.95


@pytest.fixture(scope="module")
def runs(generated_splits, tmp_path_factory):
    """→ dict(cfg, paths, eps, order): ``orced_inference`` run on both sides."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("torch_orced")
    cfg = JaxConfig(GEN_DATA_PATH=gen, MODEL_NAME=NAME, TRAIN_CLASSES=(0, 1, 2),
                    NMAX=64, NSTEPS=12, CROP_STEP=4, **DIMS)
    x, _ = JaxDataset(JAX_SPLIT.TRAIN, gen).load_all()
    enc = FlaxORCEDEncoder(n_out_labels=3, sup_latent_dim=cfg.SUP_LATENT_DIM,
                           pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=cfg.DTC_FILTERS)
    # 30 train-mode applies bring the running statistics near the batch's,
    # so the latents spread across crops
    enc_vars = flax_orced_encoder_vars(enc, x[:16], seed=SEED, steps=30)
    dec = FlaxORCEDDecoder(nsteps=cfg.NSTEPS, nmax_points=cfg.NMAX, nfeatures=cfg.NFEATURES)
    dec_vars = _perturbed(dec.init(jax.random.PRNGKey(SEED), jnp.zeros((1, cfg.SUP_LATENT_DIM))),
                          np.random.default_rng(SEED + 1))
    run_dir = str(root / "src" / NAME)
    cfg.save(os.path.join(run_dir, "config.json"))
    save_params(enc_vars, module_path(run_dir, NAME, "E"))
    save_params(dec_vars, module_path(run_dir, NAME, "G"))
    save_params(flax_mean_learner_vars(3, cfg.SUP_LATENT_DIM, seed=SEED),
                module_path(run_dir, NAME, "ML"))

    rng = np.random.default_rng(SEED + 2)
    eps, order = {}, {}
    for key, split in (("train", JAX_SPLIT.TRAIN), ("test", JAX_SPLIT.TEST),
                       ("unseen", JAX_SPLIT.UNSEEN)):
        names = JaxDataset(split, gen).filenames
        eps[key] = rng.normal(size=(len(names), cfg.SUP_LATENT_DIM)).astype(np.float32)
        order[key] = names[::-1] if key == "train" else names  # the hook reorders

    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(root / side)
        shutil.copytree(run_dir, os.path.join(paths[side], NAME))
    common = dict(generate_dataset=False, batch_size=BATCH, eps_streams=eps, crop_order=order)
    jax_orced.orced_inference([NAME], models_path=paths["jax"],
                              figures_path=str(root / "fig_jax"), **common)
    orced.orced_inference([NAME], models_path=paths["port"], figures_path=str(root / "fig_port"),
                          device="cpu", dump_calibration=True, **common)
    return dict(cfg=cfg, root=root, paths=paths, eps=eps, order=order)


def _calibration(runs):
    return dict(np.load(os.path.join(runs["paths"]["port"], NAME, "orced_calibration.npz")))


def _jax_pass(runs, key, split):
    """The JAX package's per-crop (preds, z, re) on one split, in the
    fixture's order and with its eps."""
    cfg = runs["cfg"]
    _, encoder, decoder, enc_vars, dec_vars, _ = jax_orced.orced_inference_setup(
        NAME, models_path=runs["paths"]["jax"], generate_dataset=False)
    ds = JaxDataset(split, cfg.GEN_DATA_PATH)
    x, _ = ds.load_all()
    pos = {f: i for i, f in enumerate(ds.filenames)}
    x = x[np.array([pos[f] for f in runs["order"][key]])]
    n = len(x) if key != "train" else (len(x) // BATCH) * BATCH
    return jax_orced._orced_pass(encoder, decoder, enc_vars, dec_vars, x[:n],
                                 jax.random.PRNGKey(0), BATCH, eps=runs["eps"][key][:n])


def test_outputs_equal_the_jax_package(runs):
    for stem in ("ensemble_ood_final_preds_fixed.npy", "ensemble_ood_final_labels_fixed.npy"):
        want = np.load(os.path.join(runs["root"], "fig_jax", NAME, stem))
        got = np.load(os.path.join(runs["root"], "fig_port", NAME, stem))
        assert got.dtype == want.dtype and len(got) > 0
        np.testing.assert_array_equal(got, want)
    with open(os.path.join(runs["paths"]["jax"], NAME, "ensemble_ood_log.json")) as f:
        want = json.load(f)
    with open(os.path.join(runs["paths"]["port"], NAME, "ensemble_ood_log.json")) as f:
        assert json.load(f) == want


def test_decisions_take_both_branches(runs):
    preds = np.load(os.path.join(runs["root"], "fig_port", NAME,
                                 "ensemble_ood_final_preds_fixed.npy"))
    assert (preds == 3).any() and (preds < 3).any(), "the fixture never rejects or never accepts"


def test_crops_are_clear_of_the_thresholds(runs):
    cal = _calibration(runs)
    stats = orced.ORCEDClassStats(cal["means_z"], cal["stds_z"], cal["thresholds_re"],
                                  int(cal["n_labels"]))
    keep = cal["unseen_keep"]
    preds = np.concatenate([cal["test_preds"], cal["unseen_preds"][keep]])
    z = np.concatenate([cal["test_z"], cal["unseen_z"][keep]])
    re = np.concatenate([cal["test_re"], cal["unseen_re"][keep]])
    thr = stats.thresholds_re[preds]
    assert np.min(np.abs(re - thr) / thr) > RE_MARGIN
    assert np.min(np.abs(orced.orced_latent_scores(stats, z) - orced.THRESHOLD_G)) > P_MARGIN


@pytest.mark.parametrize("key,split", [("train", JAX_SPLIT.TRAIN), ("test", JAX_SPLIT.TEST)],
                         ids=["train", "test"])
def test_per_crop_arrays_match(runs, key, split):
    cal = _calibration(runs)
    preds, z, re = _jax_pass(runs, key, split)
    np.testing.assert_array_equal(cal[f"{key}_preds"], preds)
    np.testing.assert_allclose(cal[f"{key}_z"], z, **TOL)
    np.testing.assert_allclose(cal[f"{key}_re"], re, **TOL)


def test_class_stats_and_criteria_equal_the_jax_package():
    rng = np.random.default_rng(3)
    n_tr, n_te, k, d = 64, 40, 3, 8
    re_tr = np.abs(rng.normal(size=n_tr)) + 1
    z_tr = rng.normal(size=(n_tr, d))
    gt = rng.integers(0, k, n_tr)
    pr = np.where(rng.random(n_tr) < 0.7, gt, rng.integers(0, k, n_tr))
    te_pred = rng.integers(0, k, n_te)
    z_te = rng.normal(size=(n_te, d)) * 2
    re_te = np.abs(rng.normal(size=n_te)) * 3
    want = jax_orced.orced_class_stats(re_tr, z_tr, gt, pr)
    got = orced.orced_class_stats(re_tr, z_tr, gt, pr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = orced.ORCEDClassStats(*want)
    for g, w in zip(orced.orced_criteria(stats, 0.95, te_pred, z_te, re_te),
                    jax_orced.orced_criteria(want, 0.95, te_pred, z_te, re_te)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        orced.orced_ensemble_ood_detection(re_tr, z_tr, 0.95, gt, pr, te_pred, z_te, re_te),
        jax_orced.orced_ensemble_ood_detection(re_tr, z_tr, 0.95, gt, pr, te_pred, z_te, re_te),
    )


def test_openset_helpers_equal_the_jax_package():
    rng = np.random.default_rng(4)
    mean, std, z = rng.normal(size=5), rng.uniform(0.3, 2, 5), rng.normal(size=(9, 5))
    np.testing.assert_array_equal(openset.hyperrectangle_prob(mean, std, z),
                                  jax_openset.hyperrectangle_prob(mean, std, z))
    x = rng.normal(size=11)
    np.testing.assert_array_equal(openset.normal_pdf(x, 0.3, 1.7),
                                  jax_openset.normal_pdf(x, 0.3, 1.7))
    assert openset.openness(6, 10) == jax_openset.openness(6, 10)


def test_serving_equals_the_jax_package_and_the_eval_path(runs):
    """16 test crops through both packages' serving forward + host
    epilogue, with the run's class statistics and the fixture's eps: the
    same decisions and flags, and those of ``orced_apply_ood``."""
    cal = _calibration(runs)
    cfg = runs["cfg"]
    x, _ = RadarCropDataset(SPLIT.TEST, cfg.GEN_DATA_PATH).load_all()
    x, eps = x[:16], runs["eps"]["test"][:16]  # the test split is in its sorted order
    stat_args = (cal["means_z"], cal["stds_z"], cal["thresholds_re"], int(cal["n_labels"]))

    _, encoder, decoder = orced.orced_inference_setup(
        NAME, device="cpu", models_path=runs["paths"]["port"], generate_dataset=False)
    forward = make_orced_forward_fn(encoder, decoder)
    preds, z, re = forward(torch.from_numpy(x), torch.from_numpy(eps))
    got = orced_decide_host(preds, z, re, *stat_args)

    _, jenc, jdec, ev, dv, _ = jax_orced.orced_inference_setup(
        NAME, models_path=runs["paths"]["jax"], generate_dataset=False)
    jp, jz, jre = jax.device_get(jax_serving.make_orced_forward_fn(jenc, jdec)(
        ev, dv, jnp.asarray(x), jnp.asarray(eps)))
    np.testing.assert_array_equal(preds.numpy(), jp)
    np.testing.assert_allclose(z.numpy(), jz, **TOL)
    np.testing.assert_allclose(re.numpy(), jre, **TOL)
    want = jax_serving.orced_decide_host(jp, jz, jre, *stat_args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    stats = orced.ORCEDClassStats(*stat_args)
    np.testing.assert_array_equal(
        got[0], orced.orced_apply_ood(stats, 0.95, cal["test_preds"][:16], cal["test_z"][:16],
                                      cal["test_re"][:16]))


def test_fresh_noise_is_seeded(runs, tmp_path):
    """Without eps_streams each split draws from its own seeded generator:
    the same seed gives the same files, another seed other latents."""
    src = os.path.join(runs["paths"]["port"], NAME)
    out = []
    for i, seed in enumerate((3, 3, 4)):
        models = str(tmp_path / f"m{i}")
        shutil.copytree(src, os.path.join(models, NAME))
        orced.orced_inference([NAME], models_path=models, figures_path=str(tmp_path / f"f{i}"),
                              device="cpu", generate_dataset=False, batch_size=BATCH, seed=seed,
                              dump_calibration=True)
        out.append(dict(np.load(os.path.join(models, NAME, "orced_calibration.npz"))))
    for key in ("test_z", "test_re", "unseen_preds"):
        np.testing.assert_array_equal(out[0][key], out[1][key])
    assert not np.array_equal(out[0]["test_z"], out[2]["test_z"])


def test_generate_dataset_and_confusion_png(runs, tmp_path):
    """``generate_dataset=True`` (the default) rewrites the run's splits
    from the raw tracks under ``data_path`` as the JAX setup does (the same
    files, bit-equal), and the confusion PNG is written by default, the
    matrix of the final decisions."""
    raw = str(tmp_path / "raw")
    generate_synthetic_raw_dataset(raw, n_subjects=10, tracks_per_scenario=10,
                                   frames_per_track=(20, 30), seed=12)
    models = str(tmp_path / "models")
    shutil.copytree(os.path.join(runs["paths"]["port"], NAME), os.path.join(models, NAME))
    config_path = os.path.join(models, NAME, "config.json")
    cfg = PortConfig.load(config_path).replace(GEN_DATA_PATH=str(tmp_path / "gen_port"),
                                               DATA_PATH=str(tmp_path / "absent"))
    cfg.save(config_path)
    orced.orced_inference([NAME], models_path=models, figures_path=str(tmp_path / "fig"),
                          data_path=raw, device="cpu", batch_size=BATCH)
    jax_generate_splits(data_path=raw, gen_data_path=str(tmp_path / "gen_jax"),
                        train_classes=cfg.TRAIN_CLASSES, seed=0, nmax_points=cfg.NMAX,
                        nsteps=cfg.NSTEPS, crop_step=cfg.CROP_STEP, verbose=False)
    assert_splits_equal(str(tmp_path / "gen_port"), str(tmp_path / "gen_jax"))
    figures = tmp_path / "fig" / NAME
    preds = np.load(figures / "ensemble_ood_final_preds_fixed.npy")
    labels = np.load(figures / "ensemble_ood_final_labels_fixed.npy")
    image = np.rint(mpimg.imread(str(figures / "openset_cnfmtrx_ensemble_ood_fixed.png")) * 255)
    cm = openset_confusion_matrix(labels, preds, cfg.n_classes)
    cell = image.shape[0] // cm.shape[0]
    steps = 255 - image[cell // 2::cell, cell // 2::cell, 0]  # the ramp's red is 255 - step
    np.testing.assert_allclose(steps / 255, cm, rtol=0, atol=1 / 255)
