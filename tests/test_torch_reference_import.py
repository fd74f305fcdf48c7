"""The port's reference run-folder import against the JAX package's
(``scripts/import_reference_run.py``), on the CPU.

The fake reference folders are built on the JAX side, as
``tests/test_import_reference.py`` builds them: flax inits mapped through
``tools/transplant.py``'s forward maps, and a ``config.pkl`` pickled
against a ``constants`` module that is gone at load time. Both importers
read the same folders; the port's must write the JAX importer's files
byte for byte, recover the trees bit for bit and refuse what the JAX
importer refuses, with the same exception type. The slice as a whole: a
V4 folder at NMAX=48, NSTEPS=12, imported by each package, is scored by
each package's ``pcaa_inference`` with equal decisions and latents within
atol 1e-5 (the f32 difference of the two encoders is about 1e-6; the
seed leaves every score more than 1e-3 from the threshold, which the
test asserts); an imported OR-CED folder's encoder and decoder agree with
JAX's within 1e-5.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.data.splits import generate_splits as jax_generate_splits
from opensetgaitrecognition_pcaa_tpu.infer.pcaa import pcaa_inference as jax_pcaa_inference
from opensetgaitrecognition_pcaa_tpu.models import (
    CGDecoder,
    CGDiscriminator,
    CGEncoder,
    GaussianMeanLearner,
    ORCEDDecoder,
    ORCEDEncoder,
)
from opensetgaitrecognition_pcaa_tpu.models.pcaa import ProjectionHead
from scripts import import_reference_run as jax_import
from tools.transplant import (
    cg_encoder_state_dict,
    mean_learner_state_dict,
    orced_decoder_state_dict,
    orced_encoder_state_dict,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO, VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import orced_inference_setup
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference, pcaa_inference_setup
from opensetgaitrecognition_pcaa_tpu_torch.scripts import import_reference_run as port_import
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path

from tests.test_import_reference import _linear_sd, _reference_config_pickle
from tests.test_torch_models import flax_encoder_vars

T, N, C, NL, LAT = 6, 16, 4, 3, 8
DIMS = dict(pointnet_out_dim=32, dtc_filters=(8, 16))
# the slice test's crops: NMAX=48, NSTEPS=12
SLICE_T, SLICE_N, SLICE_LAT = 12, 48, 16
SLICE_SEED = 4
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_trees_bitequal(got, want, tag):
    fg, fw = _flat(got), _flat(jax.device_get(want))
    assert set(fg) == set(fw), f"{tag}: key sets differ"
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), f"{tag}: {k}"


def _v4_reference_folder(root, name, t, n, lat, seed, x=None, **cfg_overrides):
    """A reference-layout V4 folder (E with its head, G, D, GPH, means,
    config.pkl) from flax inits; with ``x``, the encoder's parameters are
    perturbed and its statistics moved by 30 train-mode applies on ``x``."""
    run = root / name
    run.mkdir(parents=True)
    key = jax.random.PRNGKey(seed)
    enc = CGEncoder(n_out_labels=NL, sup_latent_dim=lat, use_projection_head=True, **DIMS)
    if x is None:
        enc_vars = enc.init(key, jnp.zeros((2, t, n, C), jnp.float32), train=False)
    else:
        enc_vars = flax_encoder_vars(enc, x, seed=seed, steps=30)
    dec_vars = CGDecoder(nsteps=t, nmax_points=n, nfeatures=C).init(
        key, jnp.zeros((2, 2 * lat), jnp.float32))
    disc_vars = CGDiscriminator().init(key, jnp.zeros((2, lat), jnp.float32),
                                       jnp.zeros((2, NL), jnp.float32))
    gph_vars = ProjectionHead(2 * lat).init(key, jnp.zeros((2, lat), jnp.float32))
    torch.save(cg_encoder_state_dict(enc_vars, use_projection_head=True), run / f"{name}_E.pt")
    torch.save(orced_decoder_state_dict(dec_vars, t, n, C), run / f"{name}_G.pt")
    torch.save(_linear_sd(disc_vars["params"], (0, 2, 4), prefix="model."), run / f"{name}_D.pt")
    torch.save(_linear_sd(gph_vars["params"], (0,)), run / f"{name}_GPH.pt")
    means = np.random.default_rng(seed).normal(0, 0.3, size=(NL, lat)).astype(np.float32)
    torch.save(torch.tensor(means), run / "discriminator_means.pt")
    overrides = dict(NSTEPS=t, NMAX=n, SUP_LATENT_DIM=lat, DEC_MLP_SIZE=t * n * C)
    overrides.update(cfg_overrides)
    (run / "config.pkl").write_bytes(_reference_config_pickle(name, **overrides))
    return str(run), enc_vars, dec_vars, disc_vars, gph_vars, means


@pytest.fixture(scope="module")
def pcaa_ref(tmp_path_factory):
    return _v4_reference_folder(tmp_path_factory.mktemp("ref"), "IMP_V4.8.0", T, N, LAT, 7)


@pytest.fixture(scope="module")
def orced_ref(tmp_path_factory):
    run = tmp_path_factory.mktemp("ref_orced") / "ORCED.4.1"
    run.mkdir()
    key = jax.random.PRNGKey(11)
    enc_vars = ORCEDEncoder(n_out_labels=NL, sup_latent_dim=LAT, **DIMS).init(
        {"params": key, "reparam": key}, jnp.zeros((2, T, N, C), jnp.float32), train=False)
    dec_vars = ORCEDDecoder(nsteps=T, nmax_points=N, nfeatures=C).init(
        key, jnp.zeros((2, LAT), jnp.float32))
    ml_vars = GaussianMeanLearner(latent_dim=LAT).init(key, jnp.eye(NL, dtype=jnp.float32),
                                                      train=False)
    torch.save(orced_encoder_state_dict(enc_vars), run / "ORCED.4.1_E.pt")
    torch.save(orced_decoder_state_dict(dec_vars, T, N, C), run / "ORCED.4.1_G.pt")
    torch.save(mean_learner_state_dict(ml_vars), run / "ORCED.4.1_ML.pt")
    (run / "config.pkl").write_bytes(_reference_config_pickle("ORCED.4.1"))
    return str(run), enc_vars, dec_vars, ml_vars


def _import_both(ref_run, root, kind="auto", **overrides):
    """Each package imports ``ref_run`` into the same ``MODELS_PATH``, the
    JAX folder moved aside before the port writes → (jax run dir, port run
    dir, port Config)."""
    out = str(root / "models")
    jax_cfg = jax_import.import_reference_run(ref_run, out, kind, **overrides)
    os.replace(out, str(root / "jax"))
    cfg = port_import.import_reference_run(ref_run, out, kind, **overrides)
    assert cfg.MODEL_NAME == jax_cfg.MODEL_NAME
    return str(root / "jax" / cfg.MODEL_NAME), cfg.run_dir(), cfg


@pytest.fixture(scope="module")
def imported(pcaa_ref, orced_ref, tmp_path_factory):
    return {kind: _import_both(ref[0], tmp_path_factory.mktemp(f"imp_{kind}"))
            for kind, ref in (("pcaa", pcaa_ref), ("orced", orced_ref))}


@pytest.mark.parametrize("kind", ["pcaa", "orced"])
def test_files_byte_equal_to_jax_import(imported, kind):
    jax_dir, port_dir, _ = imported[kind]
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert "config.json" in names and len(names) == (6 if kind == "pcaa" else 4)
    for fname in names:
        with open(os.path.join(jax_dir, fname), "rb") as a, \
                open(os.path.join(port_dir, fname), "rb") as b:
            assert a.read() == b.read(), fname


class TestConfigImport:
    def test_unpickle_without_reference(self, pcaa_ref, monkeypatch):
        monkeypatch.delitem(sys.modules, "constants", raising=False)
        raw = port_import.load_reference_config(os.path.join(pcaa_ref[0], "config.pkl"))
        assert raw["TRAIN_SCENARIOS"] == list(SCENARIO)  # the port's own enum

    def test_to_framework_config(self, pcaa_ref, tmp_path):
        path = os.path.join(pcaa_ref[0], "config.pkl")
        cfg = port_import.reference_config_to_framework(port_import.load_reference_config(path))
        assert cfg.MODEL_NAME == "IMP_V4.8.0"
        assert cfg.TRAIN_CLASSES == (0, 4, 9)
        assert all(isinstance(c, int) for c in cfg.TRAIN_CLASSES)
        assert cfg.NMAX == N and cfg.NSTEPS == T and cfg.SUP_LATENT_DIM == LAT
        assert cfg.GP_WEIGHT == 15.0 and isinstance(cfg.GP_WEIGHT, float)
        assert cfg.Openness == pytest.approx(0.2254)
        assert not hasattr(cfg, "WANDB_PROJECT")
        cfg.save(str(tmp_path / "probe.json"))
        assert Config.load(str(tmp_path / "probe.json")) == cfg
        want = jax_import.reference_config_to_framework(jax_import.load_reference_config(path))
        assert cfg.to_dict() == want.to_dict()

    def test_unknown_class_refused(self, tmp_path):
        """A class that is neither importable nor a reference enum."""
        import pickle
        import types

        mod = types.ModuleType("nowhere_mod")

        class Thing:
            pass

        Thing.__module__, Thing.__qualname__ = "nowhere_mod", "Thing"
        mod.Thing = Thing
        sys.modules["nowhere_mod"] = mod
        try:
            blob = pickle.dumps({"MODEL_NAME": "x", "THING": Thing})
        finally:
            del sys.modules["nowhere_mod"]
        (tmp_path / "config.pkl").write_bytes(blob)
        for module in (jax_import, port_import):
            with pytest.raises(pickle.UnpicklingError, match="neither importable"):
                module.load_reference_config(str(tmp_path / "config.pkl"))


class TestKindDetection:
    def test_pcaa(self, pcaa_ref):
        assert port_import.detect_kind(pcaa_ref[0]) == "pcaa"

    def test_orced(self, orced_ref):
        assert port_import.detect_kind(orced_ref[0]) == "orced"


class TestPCAAImport:
    def test_tree_recovery_bitexact(self, pcaa_ref, imported):
        _, enc_vars, dec_vars, disc_vars, gph_vars, means = pcaa_ref
        _, rd, cfg = imported["pcaa"]
        name = cfg.MODEL_NAME
        assert_trees_bitequal(load_params(module_path(rd, name, "E")), enc_vars, "E")
        assert_trees_bitequal(load_params(module_path(rd, name, "G")),
                              {"params": dec_vars["params"]}, "G")
        assert_trees_bitequal(load_params(module_path(rd, name, "D")), disc_vars, "D")
        assert_trees_bitequal(load_params(module_path(rd, name, "GPH")), gph_vars, "GPH")
        np.testing.assert_array_equal(np.load(os.path.join(rd, "discriminator_means.npy")), means)

    def test_no_ml_written_for_v4(self, imported):
        _, rd, cfg = imported["pcaa"]
        assert not os.path.exists(module_path(rd, cfg.MODEL_NAME, "ML"))

    def test_inference_setup_loads_imported_folder(self, pcaa_ref, imported):
        """The port's inference setup reads the imported folder: its encoder
        gives the JAX encoder's outputs on the source weights."""
        enc_vars = pcaa_ref[1]
        _, rd, cfg = imported["pcaa"]
        _, enc, _ = pcaa_inference_setup(cfg.MODEL_NAME, VARIATION.V4, device="cpu",
                                         models_path=cfg.MODELS_PATH, generate_dataset=False)
        x = np.random.default_rng(0).normal(size=(3, T, N, C)).astype(np.float32)
        want = CGEncoder(n_out_labels=NL, sup_latent_dim=LAT, use_projection_head=True,
                         **DIMS).apply(enc_vars, x, train=False)
        with torch.no_grad():
            got = enc(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


class TestORCEDImport:
    def test_tree_recovery_bitexact(self, orced_ref, imported):
        _, enc_vars, dec_vars, ml_vars = orced_ref
        _, rd, cfg = imported["orced"]
        name = cfg.MODEL_NAME
        assert_trees_bitequal(load_params(module_path(rd, name, "E")), enc_vars, "E")
        assert_trees_bitequal(load_params(module_path(rd, name, "G")),
                              {"params": dec_vars["params"]}, "G")
        assert_trees_bitequal(load_params(module_path(rd, name, "ML")), ml_vars, "ML")

    def test_imported_modules_match_jax(self, orced_ref, imported):
        """The port's OR-CED setup on the imported folder: latents, logits
        and the reconstruction of the JAX modules within 1e-5, with the
        same eps."""
        _, enc_vars, dec_vars, _ = orced_ref
        _, _, cfg = imported["orced"]
        _, enc, dec = orced_inference_setup(cfg.MODEL_NAME, device="cpu",
                                            models_path=cfg.MODELS_PATH, generate_dataset=False)
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, T, N, C)).astype(np.float32)
        eps = rng.normal(size=(3, LAT)).astype(np.float32)
        want = ORCEDEncoder(n_out_labels=NL, sup_latent_dim=LAT, **DIMS).apply(
            enc_vars, x, train=False, eps=jnp.asarray(eps))
        with torch.no_grad():
            got = enc(torch.from_numpy(x), eps=torch.from_numpy(eps))
            rec = dec(got[1])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
        want_rec = ORCEDDecoder(nsteps=T, nmax_points=N, nfeatures=C).apply(dec_vars, want[1])
        np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), rtol=ATOL, atol=ATOL)


def _broken_copy(src, tmp_path_factory, tag, name=None):
    dst = tmp_path_factory.mktemp(tag) / (name or os.path.basename(src))
    shutil.copytree(src, dst)
    return dst


def _edit_pt(path, edit):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    edit(sd)
    torch.save(sd, path)


def _drop_sup1_bias(run, name):
    _edit_pt(run / f"{name}_E.pt", lambda sd: sd.pop("MLP_sup1.0.bias"))


def _extra_encoder_key(run, name):
    _edit_pt(run / f"{name}_E.pt", lambda sd: sd.update({"MLP_extra.0.weight": torch.zeros(3, 3)}))


def _extra_disc_layer(run, name):
    _edit_pt(run / f"{name}_D.pt", lambda sd: sd.update(
        {"model.6.weight": torch.zeros(1, 1), "model.6.bias": torch.zeros(1)}))


def _disc_without_prefix(run, name):
    _edit_pt(run / f"{name}_D.pt", lambda sd: sd.update({"0.weight": sd.pop("model.0.weight")}))


def _two_classes(run, name):
    (run / "config.pkl").write_bytes(_reference_config_pickle(name, TRAIN_CLASSES=[0, 4]))


def _wrong_means(run, name):
    torch.save(torch.zeros(NL + 1, LAT), run / "discriminator_means.pt")


def _changed_decoder(run, name):
    _edit_pt(run / f"{name}_G.pt", lambda sd: sd.update({"dense5.bias": sd["dense5.bias"][:-4]}))


# (edit, exception, message): each refusal of the JAX importer
REFUSALS = {
    "incomplete checkpoint": (_drop_sup1_bias, KeyError, None),
    "extra checkpoint keys": (_extra_encoder_key, ValueError, "does not declare"),
    "extra head layers": (_extra_disc_layer, ValueError, "Linear layers"),
    "discriminator keys without model.": (_disc_without_prefix, ValueError, "'model.' prefix"),
    "config and checkpoint disagree": (_two_classes, ValueError, "config-declared"),
    "means of the wrong shape": (_wrong_means, ValueError, "discriminator_means shape"),
    "decoder bias narrower than its weight": (_changed_decoder, ValueError, "shape mismatch"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_matches_jax(pcaa_ref, tmp_path_factory, case):
    """Both importers refuse the edited folder with the same exception
    type, and neither leaves a run folder behind; an earlier run folder of
    the same name stays as it was."""
    edit, exc, match = REFUSALS[case]
    name = "IMP_V4.8.0"
    broken = _broken_copy(pcaa_ref[0], tmp_path_factory, "broken")
    edit(broken, name)
    for module in (jax_import, port_import):
        out = tmp_path_factory.mktemp("out")
        with pytest.raises(exc, match=match):
            module.import_pcaa_run(str(broken), str(out))
        assert os.listdir(out) == []
    out = tmp_path_factory.mktemp("out_existing")
    (out / name).mkdir()
    (out / name / "config.json").write_text("{}")
    with pytest.raises(exc):
        port_import.import_pcaa_run(str(broken), str(out))
    assert os.listdir(out) == [name] and os.listdir(out / name) == ["config.json"]
    assert (out / name / "config.json").read_text() == "{}"


class TestImportGuards:
    def test_renamed_folder_detects_and_imports(self, pcaa_ref, tmp_path_factory):
        renamed = _broken_copy(pcaa_ref[0], tmp_path_factory, "renamed", "backup")
        assert port_import.detect_kind(str(renamed)) == "pcaa"
        cfg = port_import.import_pcaa_run(str(renamed), str(tmp_path_factory.mktemp("out")))
        assert cfg.MODEL_NAME == "IMP_V4.8.0"
        assert_trees_bitequal(load_params(module_path(cfg.run_dir(), cfg.MODEL_NAME, "E")),
                              pcaa_ref[1], "E")

    def test_checkpoint_stem_mismatch_named(self, pcaa_ref, tmp_path_factory):
        mixed = _broken_copy(pcaa_ref[0], tmp_path_factory, "mixed")
        os.rename(mixed / "IMP_V4.8.0_E.pt", mixed / "OTHER_E.pt")
        for module in (jax_import, port_import):
            with pytest.raises(FileNotFoundError, match="MODEL_NAME"):
                module.detect_kind(str(mixed))

    def test_dead_reference_dph_skipped(self, pcaa_ref, tmp_path_factory, capsys):
        """The reference V4's discriminator head, declared 2·latent → latent
        and never run, is skipped with a note, as the JAX importer does."""
        run = _broken_copy(pcaa_ref[0], tmp_path_factory, "dead_dph")
        torch.save({"0.weight": torch.zeros(LAT, 2 * LAT), "0.bias": torch.zeros(LAT)},
                   run / "IMP_V4.8.0_DPH.pt")
        root = tmp_path_factory.mktemp("dead_dph_out")
        jax_dir, port_dir, _ = _import_both(str(run), root)
        assert "dead" in capsys.readouterr().out
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
        assert not os.path.exists(os.path.join(port_dir, "IMP_V4.8.0_DPH.msgpack"))
        assert os.path.exists(os.path.join(port_dir, "IMP_V4.8.0_GPH.msgpack"))

    def test_cli_overrides_paths(self, orced_ref, tmp_path, capsys):
        out = str(tmp_path / "models")
        port_import.main(["--ref-run", orced_ref[0], "--out-models", out,
                          "--data-path", "RAW", "--gen-data-path", "GEN"])
        assert "round-trip verified" in capsys.readouterr().out
        cfg = Config.load(os.path.join(out, "ORCED.4.1", "config.json"))
        assert (cfg.DATA_PATH, cfg.GEN_DATA_PATH, cfg.MODELS_PATH) == ("RAW", "GEN", out)


# ---------------------------------------------------------------------------
# the slice: an imported V4 folder scored by both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scored(synthetic_raw, tmp_path_factory):
    gen = str(tmp_path_factory.mktemp("gen48"))
    jax_generate_splits(data_path=synthetic_raw, gen_data_path=gen, train_classes=[0, 1, 2],
                        seed=0, nmax_points=SLICE_N, nsteps=SLICE_T, crop_step=4, n_subjects=5,
                        verbose=False)
    from opensetgaitrecognition_pcaa_tpu.config import SPLIT as JAX_SPLIT
    from opensetgaitrecognition_pcaa_tpu.data.dataset import RadarCropDataset

    x, _ = RadarCropDataset(JAX_SPLIT.TRAIN, gen).load_all()
    root = tmp_path_factory.mktemp("slice")
    ref = _v4_reference_folder(root / "ref", "SLICE_V4.3.0", SLICE_T, SLICE_N, SLICE_LAT,
                               SLICE_SEED, x=x[:16], TRAIN_CLASSES=[0, 1, 2], CROP_STEP=4)
    jax_dir, port_dir, cfg = _import_both(ref[0], root, GEN_DATA_PATH=gen)
    common = dict(ks=(1, 2), generate_dataset=False, dump_calibration=True)
    jax_pcaa_inference([cfg.MODEL_NAME], models_path=os.path.dirname(jax_dir),
                       figures_path=str(root / "fig_jax"), **common)
    pcaa_inference([cfg.MODEL_NAME], models_path=cfg.MODELS_PATH,
                   figures_path=str(root / "fig_port"), device="cpu", **common)
    return jax_dir, port_dir, cfg, ref[1], gen


def test_imported_v4_decisions_equal_jax(scored):
    jax_dir, port_dir, _, _, _ = scored
    want = np.load(os.path.join(jax_dir, "calibration.npz"))
    got = np.load(os.path.join(port_dir, "calibration.npz"))
    thr = float(want["log_threshold"])
    scores = np.concatenate([want["test_ll"], want["unseen_ll"]])
    others = scores[scores != thr]  # the threshold is itself a crop's score
    assert np.isfinite(thr) and np.abs(others - thr).min() > 1e-3
    for key in ("test_preds", "test_labels", "unseen_preds", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(got[key], want[key])
    for k in (1, 2):
        for stem in (f"final_preds_{k}.npy", f"final_labels_{k}.npy"):
            w, g = np.load(os.path.join(jax_dir, stem)), np.load(os.path.join(port_dir, stem))
            assert len(w) > 0
            np.testing.assert_array_equal(g, w)


def test_imported_v4_latents_match_jax(scored):
    """The latents of every TEST crop from the port's setup on its
    imported folder against the JAX encoder on the source weights."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset

    _, _, cfg, enc_vars, gen = scored
    _, enc, _ = pcaa_inference_setup(cfg.MODEL_NAME, VARIATION.V4, device="cpu",
                                     models_path=cfg.MODELS_PATH, generate_dataset=False)
    x, _ = RadarCropDataset(SPLIT.TEST, gen, sequential=True).load_all()
    _, want = CGEncoder(n_out_labels=NL, sup_latent_dim=SLICE_LAT, use_projection_head=True,
                        **DIMS).apply(enc_vars, x, train=False)
    with torch.no_grad():
        _, got = enc(torch.from_numpy(x))
    assert float(np.asarray(want).std(axis=0).mean()) > 1e-2  # the latents spread
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
