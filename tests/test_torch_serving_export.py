"""The port's serving artifact (``.osgr``) against the JAX package's, and
against the port's in-process decisions, on the CPU.

Two run folders at ``tests/test_scripts.py``'s TINY dims (NMAX 24, NSTEPS
8, ``POINTNET_OUT_DIM`` 32) come from flax inits, every parameter
perturbed and the running statistics moved by train-mode applies, saved by
the JAX package: a V4 run with seeded mixture centres and an ORCED run.
Both packages export each folder. The tolerances:

- the two custom ops equal their plain functions bit for bit on the CPU;
- PCAA: the thresholds within rtol 1e-6; decisions and above-threshold
  counts equal on every window whose crops' scores lie more than 1e-4
  from the threshold (the f32 gap of the two encoders is about 1e-6);
  against the port's in-process ``decide`` the artifact is bitwise equal
  at batches 1, 3 and 7 (the batch is symbolic);
- ORCED, the raw forward on the same crops and eps: preds equal, z within
  atol 1e-5, rec errors within rtol 1e-4; decisions through the host
  epilogue with the JAX artifact's statistics equal the JAX artifact's
  except knife-edge crops (a rec error within rtol 1e-3 of its class's
  threshold, a latent score within 1e-6 of 0.95); the port artifact's
  statistics equal ``orced_inference(dump_calibration=True)``'s.
"""

import json
import os
import shutil
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.data.splits import generate_splits as jax_generate_splits
from opensetgaitrecognition_pcaa_tpu.infer import serving as jax_serving
from opensetgaitrecognition_pcaa_tpu.models import (
    CGEncoder as FlaxCGEncoder,
    ORCEDDecoder as FlaxORCEDDecoder,
    ORCEDEncoder as FlaxORCEDEncoder,
)
from opensetgaitrecognition_pcaa_tpu.train.run_folder import module_path, save_params

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.infer import serving
from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
    THRESHOLD_G,
    ORCEDClassStats,
    orced_inference,
    orced_latent_scores,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
    calibrate_open_set,
    pcaa_inference_setup,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import seq_chamfer
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer_kernel import seq_chamfer_op
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_infer import (
    FOLDED_KEYS,
    pointnet_pool_infer_op,
    pointnet_pool_ref,
)

from tests.test_scripts import TINY
from tests.test_torch_models import flax_encoder_vars
from tests.test_torch_orced_models import (
    _perturbed,
    flax_mean_learner_vars,
    flax_orced_encoder_vars,
)

PCAA_NAME = "SRV_V4.3.1"
ORCED_NAME = "ORCED_SRV.3.1"
DIMS = {k: TINY[k] for k in ("NMAX", "NSTEPS", "CROP_STEP", "POINTNET_OUT_DIM", "DTC_FILTERS",
                             "SUP_LATENT_DIM")}
K = 2
SEED = 4
BATCH = 16  # the ORCED statistics pass
MARGIN = 1e-4  # distance of a crop's score from the PCAA threshold
RE_EDGE, P_EDGE = 1e-3, 1e-6  # ORCED knife edges (PERF.md §2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny: one intra-op thread per process keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folders(synthetic_raw, tmp_path_factory):
    """→ dict(gen, models, cfg): the V4 and ORCED run folders over splits
    written at TINY dims."""
    root = tmp_path_factory.mktemp("torch_serving")
    gen = str(root / "gen")
    jax_generate_splits(data_path=synthetic_raw, gen_data_path=gen, train_classes=[0, 1, 2],
                        seed=0, nmax_points=DIMS["NMAX"], nsteps=DIMS["NSTEPS"],
                        crop_step=DIMS["CROP_STEP"], n_subjects=5, verbose=False)
    models = str(root / "models")
    cfg = JaxConfig(GEN_DATA_PATH=gen, DATA_PATH=synthetic_raw, MODELS_PATH=models,
                    TRAIN_CLASSES=(0, 1, 2), **DIMS)
    x = np.asarray(RadarCropDataset(SPLIT.TRAIN, gen).load_all()[0][:16])
    latent, width, filters = cfg.SUP_LATENT_DIM, cfg.POINTNET_OUT_DIM, cfg.DTC_FILTERS

    run_dir = os.path.join(models, PCAA_NAME)
    cfg.replace(MODEL_NAME=PCAA_NAME).save(os.path.join(run_dir, "config.json"))
    enc = FlaxCGEncoder(n_out_labels=3, sup_latent_dim=latent, pointnet_out_dim=width,
                        dtc_filters=filters, use_projection_head=True)
    enc_vars = flax_encoder_vars(enc, x, seed=SEED, steps=30)
    save_params(enc_vars, module_path(run_dir, PCAA_NAME, "E"))
    # the centres: each train class's mean latent, so that seen crops score
    # above unseen ones and the windows are both accepted and rejected
    x_tr, y_tr = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    _, fv = enc.apply(enc_vars, jnp.asarray(x_tr), train=False)
    means = np.stack([np.asarray(fv)[y_tr == c].mean(axis=0) for c in range(3)])
    np.save(os.path.join(run_dir, "discriminator_means.npy"), means.astype(np.float32))

    run_dir = os.path.join(models, ORCED_NAME)
    cfg.replace(MODEL_NAME=ORCED_NAME).save(os.path.join(run_dir, "config.json"))
    enc = FlaxORCEDEncoder(n_out_labels=3, sup_latent_dim=latent, pointnet_out_dim=width,
                           dtc_filters=filters)
    save_params(flax_orced_encoder_vars(enc, x, seed=SEED, steps=30),
                module_path(run_dir, ORCED_NAME, "E"))
    dec = FlaxORCEDDecoder(nsteps=cfg.NSTEPS, nmax_points=cfg.NMAX, nfeatures=cfg.NFEATURES)
    save_params(_perturbed(dec.init(jax.random.PRNGKey(SEED), jnp.zeros((1, latent))),
                           np.random.default_rng(SEED + 1)),
                module_path(run_dir, ORCED_NAME, "G"))
    save_params(flax_mean_learner_vars(3, latent, seed=SEED),
                module_path(run_dir, ORCED_NAME, "ML"))
    return dict(gen=gen, models=models, cfg=cfg, root=root)


@pytest.fixture(scope="module")
def pcaa(folders):
    """Both packages' PCAA artifacts of the V4 folder at k = 2."""
    root, models = folders["root"], folders["models"]
    jax_path, jax_meta = jax_serving.export_pcaa_decision(
        PCAA_NAME, K, models_path=models, generate_dataset=False,
        out_path=str(root / "jax_pcaa.osgr"))
    path, meta = serving.export_pcaa_decision(
        PCAA_NAME, K, models_path=models, generate_dataset=False,
        out_path=str(root / "port_pcaa.osgr"), device="cpu")
    return dict(jax=jax_serving.load_serving_artifact(jax_path), jax_meta=jax_meta,
                jax_path=jax_path, path=path, meta=meta,
                port=serving.load_serving_artifact(path, device="cpu"))


@pytest.fixture(scope="module")
def orced(folders):
    """Both packages' ORCED artifacts of the ORCED folder."""
    root, models = folders["root"], folders["models"]
    jax_path, _ = jax_serving.export_orced_decision(
        ORCED_NAME, models_path=models, generate_dataset=False, batch_size=BATCH,
        out_path=str(root / "jax_orced.osgr"))
    path, meta = serving.export_orced_decision(
        ORCED_NAME, models_path=models, generate_dataset=False, batch_size=BATCH,
        out_path=str(root / "port_orced.osgr"), device="cpu")
    return dict(jax=jax_serving.load_serving_artifact(jax_path), path=path, meta=meta,
                port=serving.load_serving_artifact(path, device="cpu"))


def _windows(folders, split: SPLIT, k: int):
    """Single-label sequential k-windows of a split → (windows, starts)."""
    x, y = RadarCropDataset(split, folders["gen"], sequential=True).load_all()
    starts = [s for s in range(0, len(y) - k + 1, k) if len(np.unique(y[s:s + k])) == 1]
    return np.stack([x[s:s + k] for s in starts]), np.array(starts)


# --- the custom ops -----------------------------------------------------------


def _pointnet_case():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 7, 4)).astype(np.float32))
    shapes = [(4, 8), (8,), (8, 8), (8,), (8, 16), (16,), (16, 16), (16,)]
    weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    return x, weights


def _chamfer_case():
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.normal(size=(3, 4, 9, 4)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(3, 4, 6, 4)).astype(np.float32)))


@pytest.mark.parametrize("which", ["pointnet", "chamfer"])
def test_op_passes_opcheck(which):
    op, args = ((pointnet_pool_infer_op, _pointnet_case()) if which == "pointnet"
                else (seq_chamfer_op, _chamfer_case()))
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("which", ["pointnet", "chamfer"])
def test_op_equals_its_plain_function_bitwise(which):
    if which == "pointnet":
        x, weights = _pointnet_case()
        got = torch.ops.osgr_torch.pointnet_pool_infer(x, weights)
        want = pointnet_pool_ref(x, dict(zip(FOLDED_KEYS, weights)))
    else:
        preds, gts = _chamfer_case()
        got = torch.ops.osgr_torch.seq_chamfer(preds, gts)
        want = seq_chamfer(preds, gts, avg_out=False)
    assert got.shape == want.shape and torch.equal(got, want)


# --- PCAA -----------------------------------------------------------------------


def test_pcaa_meta_has_the_jax_keys(pcaa):
    meta, jax_meta = pcaa["meta"], pcaa["jax_meta"]
    assert set(jax_meta) | {"ops"} == set(meta)
    assert meta["format"] == "osgr-serving-torch-v1" and jax_meta["format"] == "osgr-serving-v1"
    assert meta["ops"] == ["osgr_torch::pointnet_pool_infer"]
    assert meta["outputs"] == ["decisions (b,) i64", "n_above_threshold (b,) i64"]
    for key in ("model", "model_name", "variation", "k", "n_labels", "unknown_label", "inputs"):
        assert meta[key] == jax_meta[key], key
    assert pcaa["port"].meta == meta


def test_pcaa_artifact_decides_as_the_jax_artifact(folders, pcaa):
    thr, jax_thr = pcaa["meta"]["log_threshold"], pcaa["jax_meta"]["log_threshold"]
    assert np.isfinite(jax_thr)
    np.testing.assert_allclose(thr, jax_thr, rtol=1e-6)
    cfg, encoder, means = pcaa_inference_setup(PCAA_NAME, VARIATION.V4, device="cpu",
                                               models_path=folders["models"],
                                               generate_dataset=False)
    cal = calibrate_open_set(encoder, means, cfg, device="cpu")
    assert cal.log_threshold == thr
    checked = 0
    for split, ll in ((SPLIT.TEST, cal.test_ll), (SPLIT.UNSEEN, cal.unseen_ll)):
        wins, starts = _windows(folders, split, K)
        dec, n_above = pcaa["port"].decide(wins)
        jax_dec, jax_n = (np.asarray(a) for a in pcaa["jax"].decide(wins))
        safe = np.array([np.abs(ll[s:s + K] - thr).min() > MARGIN for s in starts])
        assert safe.mean() >= 0.9, safe.mean()
        np.testing.assert_array_equal(dec[safe], jax_dec[safe])
        np.testing.assert_array_equal(n_above[safe], jax_n[safe])
        assert dec.dtype == np.int64 and n_above.dtype == np.int64
        checked += int(safe.sum())
        if split == SPLIT.TEST:
            assert (dec[safe] < cal.n_labels).any(), "no window accepted"
        else:
            assert (dec[safe] == cal.n_labels).any(), "no window rejected"
    assert checked > 20


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_pcaa_artifact_equals_the_in_process_decide(folders, pcaa, batch):
    _, encoder, means = pcaa_inference_setup(PCAA_NAME, VARIATION.V4, device="cpu",
                                             models_path=folders["models"],
                                             generate_dataset=False)
    meta = pcaa["meta"]
    decide = serving.make_pcaa_decision_fn(encoder, meta["n_labels"], K)
    wins, _ = _windows(folders, SPLIT.UNSEEN, K)
    w = wins[5:5 + batch]
    got = pcaa["port"].decide(w)
    want = decide(means, meta["log_threshold"], torch.from_numpy(w))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, e.numpy())
    raw = pcaa["port"].call(torch.from_numpy(w))
    assert all(t.dtype == torch.int64 and t.shape == (batch,) for t in raw)


# --- ORCED ----------------------------------------------------------------------


def _crops_and_eps(folders, n=48):
    x, _ = RadarCropDataset(SPLIT.TEST, folders["gen"]).load_all()
    x = np.concatenate([x[:n // 2], RadarCropDataset(SPLIT.UNSEEN, folders["gen"]).load_all()[0]
                        [:n - n // 2]])
    eps = np.random.default_rng(9).standard_normal((len(x), DIMS["SUP_LATENT_DIM"]))
    return x, eps.astype(np.float32)


def _knife_edge(meta, preds, z, re):
    stats = ORCEDClassStats(np.asarray(meta["means_z"]), np.asarray(meta["stds_z"]),
                            np.asarray(meta["thresholds_re"]), meta["n_labels"])
    thr = stats.thresholds_re[np.asarray(preds)]
    p = orced_latent_scores(stats, np.asarray(z, np.float64))
    return ((np.abs(np.asarray(re) - thr) <= RE_EDGE * np.abs(thr))
            | (np.abs(p - THRESHOLD_G) <= P_EDGE).any(axis=0))


def test_orced_forward_equals_the_jax_artifact(folders, orced):
    x, eps = _crops_and_eps(folders)
    preds, z, re = (t.numpy() for t in orced["port"].call(x, eps))
    j_preds, j_z, j_re = (np.asarray(a) for a in orced["jax"].call(x, eps))
    assert preds.dtype == np.int64 and z.shape == (len(x), DIMS["SUP_LATENT_DIM"])
    np.testing.assert_array_equal(preds, j_preds)
    np.testing.assert_allclose(z, j_z, rtol=0, atol=1e-5)
    np.testing.assert_allclose(re, j_re, rtol=1e-4)

    jax_meta = orced["jax"].meta
    got, _, _ = serving.orced_decide_host(preds, z, re, jax_meta["means_z"], jax_meta["stds_z"],
                                          jax_meta["thresholds_re"], jax_meta["n_labels"])
    want, _, _ = orced["jax"].decide(x, eps=eps)
    edge = _knife_edge(jax_meta, j_preds, j_z, j_re)
    assert edge.mean() < 0.1
    np.testing.assert_array_equal(got[~edge], np.asarray(want)[~edge])
    assert len(set(got.tolist())) > 1


def test_orced_statistics_equal_orced_inference(folders, orced, tmp_path):
    models = str(tmp_path / "models")
    shutil.copytree(os.path.join(folders["models"], ORCED_NAME), os.path.join(models, ORCED_NAME))
    orced_inference([ORCED_NAME], models_path=models, figures_path=str(tmp_path / "fig"),
                    generate_dataset=False, batch_size=BATCH, dump_calibration=True,
                    confusion_png=False, device="cpu")
    cal = np.load(os.path.join(models, ORCED_NAME, "orced_calibration.npz"))
    meta = orced["meta"]
    for key in ("means_z", "stds_z", "thresholds_re"):
        np.testing.assert_array_equal(np.asarray(meta[key]), cal[key], err_msg=key)
    assert meta["n_labels"] == int(cal["n_labels"]) and meta["latent_dim"] == DIMS["SUP_LATENT_DIM"]
    assert meta["ops"] == ["osgr_torch::pointnet_pool_infer", "osgr_torch::seq_chamfer"]


def test_orced_decide_draws_the_jax_eps(folders, orced, monkeypatch):
    x, _ = _crops_and_eps(folders, n=6)
    drawn = {}
    for side in ("jax", "port"):
        art = orced[side]

        def recording_call(*args, real=art.call, side=side):
            drawn[side] = np.asarray(args[1]).copy()
            return real(*args)

        monkeypatch.setattr(art, "call", recording_call)
        art.decide(x, seed=5)
    assert drawn["port"].dtype == np.float32
    np.testing.assert_array_equal(drawn["port"], drawn["jax"])
    monkeypatch.undo()
    got = orced["port"].decide(x, seed=5)
    want = orced["port"].decide(x, eps=drawn["jax"])
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, e)


# --- the loader --------------------------------------------------------------------


def test_load_rejects_a_non_artifact(tmp_path):
    junk = tmp_path / "weights.msgpack"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a serving artifact.*weights.msgpack"):
        serving.load_serving_artifact(str(junk), device="cpu")


def test_load_rejects_a_jax_artifact(pcaa):
    with pytest.raises(ValueError, match="jax_pcaa.osgr.*osgr-serving-v1"):
        serving.load_serving_artifact(pcaa["jax_path"], device="cpu")


def test_load_names_an_unregistered_op(pcaa, tmp_path):
    with open(pcaa["path"], "rb") as f:
        f.read(8)
        (n,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(n))
        blob = f.read()
    meta["ops"] = ["osgr_torch::pointnet_pool_infer", "osgr_torch::not_an_op"]
    head = json.dumps(meta).encode()
    bad = tmp_path / "bad.osgr"
    bad.write_bytes(b"OSGRSRV1" + struct.pack("<Q", len(head)) + head + blob)
    with pytest.raises(ValueError, match="bad.osgr.*osgr_torch::not_an_op"):
        serving.load_serving_artifact(str(bad), device="cpu")


# --- the command line ----------------------------------------------------------------


def test_export_serving_runs_as_a_module(folders, tmp_path):
    models = str(tmp_path / "models")
    for name in (PCAA_NAME, ORCED_NAME):
        shutil.copytree(os.path.join(folders["models"], name), os.path.join(models, name))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "opensetgaitrecognition_pcaa_tpu_torch.scripts.export_serving",
         "--model-names", PCAA_NAME, ORCED_NAME, "--models-path", models, "--ks", "1", "2",
         "--no-generate-dataset", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    paths = [os.path.join(models, PCAA_NAME, f"serving_decision_k{k}.osgr") for k in (1, 2)]
    paths.append(os.path.join(models, ORCED_NAME, "serving_decision.osgr"))
    for path in paths:
        assert path in proc.stdout
        art = serving.load_serving_artifact(path, device="cpu")
        assert art.meta["model_name"] in (PCAA_NAME, ORCED_NAME)
    assert [serving.load_serving_artifact(p, device="cpu").meta["k"] for p in paths[:2]] == [1, 2]
