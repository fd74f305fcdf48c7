"""The port's run-folder export to the reference's torch contract against
the JAX package's (``scripts/export_reference_run.py``), on the CPU, and
the port's ``transplant.py`` maps against ``tools/transplant.py``.

The run folders come from the JAX side: a V4 run with the discriminator
projection head trained one epoch by JAX ``train_pcaa`` at tiny widths,
and flax-initialized ORCED, V1 and V3 folders as
``tests/test_export_reference.py`` builds them. Each package exports the
same folder; the port's ``.pt`` state_dicts must equal the JAX exporter's
key for key, in order, in dtype and bit for bit, its ``config.pkl`` must
load to equal dicts through both tolerant unpicklers, and the port's
importer must bring every tree back bit for bit.
"""

import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import SPLIT as JAX_SPLIT
from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION
from opensetgaitrecognition_pcaa_tpu.config import Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu.models import (
    CGDecoder,
    CGDiscriminator,
    CGEncoder,
    GaussianMeanLearner,
    ORCEDDecoder,
    ORCEDEncoder,
)
from opensetgaitrecognition_pcaa_tpu.models.pcaa import ProjectionHead
from opensetgaitrecognition_pcaa_tpu.train import train_pcaa as jax_train_pcaa
from opensetgaitrecognition_pcaa_tpu.train.run_folder import save_params as jax_save_params
from scripts import export_reference_run as jax_export
from scripts import import_reference_run as jax_import
from tools import transplant as jax_transplant

from opensetgaitrecognition_pcaa_tpu_torch import transplant as port_transplant
from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO, Config
from opensetgaitrecognition_pcaa_tpu_torch.scripts import export_reference_run as port_export
from opensetgaitrecognition_pcaa_tpu_torch.scripts import import_reference_run as port_import
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path

from tests.test_torch_reference_import import assert_trees_bitequal

T, N, C, NL, LAT = 6, 16, 4, 3, 8
DIMS = dict(pointnet_out_dim=32, dtc_filters=(8, 16))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_config(name, models_path, **kw):
    base = dict(NMAX=N, NSTEPS=T, CROP_STEP=2, NFEATURES=C, POINTNET_OUT_DIM=32,
                DTC_FILTERS=(8, 16), SUP_LATENT_DIM=LAT, DEC_MLP_SIZE=T * N * C,
                TRAIN_CLASSES=(0, 4, 9), BATCH_SIZE=4, EPOCHS=2, CHECKPOINT_FREQUENCY=1,
                MODEL_NAME=name, MODELS_PATH=models_path)
    base.update(kw)
    return JaxConfig(**base)


def _flax_run(root, name, variant, seed):
    """A flax-initialized run folder saved by the JAX package: ``"orced"``
    (E, G, ML), ``"V1"`` (E with its head, D, GPH, G, ML, means) or
    ``"V3"`` (E, D, means)."""
    cfg = _tiny_config(name, str(root))
    run = cfg.run_dir()
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.json"))
    key = jax.random.PRNGKey(seed)
    x0 = jnp.zeros((2, T, N, C), jnp.float32)
    z0 = jnp.zeros((2, LAT), jnp.float32)
    trees = {}
    if variant == "orced":
        trees["E"] = ORCEDEncoder(n_out_labels=NL, sup_latent_dim=LAT, **DIMS).init(
            {"params": key, "reparam": key}, x0, train=False)
        trees["G"] = ORCEDDecoder(nsteps=T, nmax_points=N, nfeatures=C).init(key, z0)
    else:
        trees["E"] = CGEncoder(n_out_labels=NL, sup_latent_dim=LAT,
                               use_projection_head=variant == "V1", **DIMS).init(key, x0,
                                                                                 train=False)
        trees["D"] = CGDiscriminator().init(key, z0, jnp.zeros((2, NL), jnp.float32))
    if variant == "V1":
        trees["GPH"] = ProjectionHead(2 * LAT).init(key, z0)
        trees["G"] = CGDecoder(nsteps=T, nmax_points=N, nfeatures=C).init(
            key, jnp.zeros((2, 2 * LAT), jnp.float32))
    if variant in ("orced", "V1"):
        trees["ML"] = GaussianMeanLearner(latent_dim=LAT).init(
            key, jnp.eye(NL, dtype=jnp.float32), train=False)
    for tag, tree in trees.items():
        jax_save_params(tree if tag in ("E", "ML") else {"params": tree["params"]},
                        module_path(run, name, tag))
    if variant != "orced":
        means = np.random.default_rng(seed).normal(size=(NL, LAT)).astype(np.float32)
        np.save(os.path.join(run, "discriminator_means.npy"), means)
    return run


@pytest.fixture(scope="module")
def runs(generated_splits, tmp_path_factory):
    """{kind: run folder}: "V4" trained by JAX (one epoch, 32 train crops,
    with the discriminator head), "orced", "V1" and "V3" flax inits."""
    gen, _ = generated_splits
    root = tmp_path_factory.mktemp("fw_models")
    x, y = RadarCropDataset(JAX_SPLIT.TRAIN, gen).load_all()
    xv, yv = RadarCropDataset(JAX_SPLIT.VALID, gen).load_all()
    cfg = _tiny_config("EXP_V4.3.0", str(root), NMAX=64, NSTEPS=12, CROP_STEP=4,
                       DEC_MLP_SIZE=12 * 64 * 4, TRAIN_CLASSES=(0, 1, 2), BATCH_SIZE=8,
                       EPOCHS=1, GEN_DATA_PATH=gen, FIGURES_PATH=str(root / "fig"))
    jax_train_pcaa(cfg, JAX_VARIATION.V4, proj_head_on_discriminator=True,
                   datasets=(x[:32], y[:32], xv[:16], yv[:16]), verbose=False)
    out = {"V4": cfg.run_dir()}
    for seed, (kind, name) in enumerate((("orced", "EXPORCED.4.1"), ("V1", "EXP_V1.8.0"),
                                         ("V3", "EXP_V3.8.0"))):
        out[kind] = _flax_run(root, name, kind, seed)
    return out


@pytest.fixture(scope="module")
def exported(runs, tmp_path_factory):
    """{kind: (JAX export dir, port export dir)}."""
    out = {}
    for kind, run in runs.items():
        root = tmp_path_factory.mktemp(f"ref_{kind}")
        out[kind] = (jax_export.export_reference_run(run, str(root / "jax")),
                     port_export.export_reference_run(run, str(root / "port")))
    return out


FILES = {"V4": ("E", "G", "D", "GPH", "DPH"), "orced": ("E", "G", "ML"),
         "V1": ("E", "D", "GPH", "G", "ML"), "V3": ("E", "D")}


@pytest.mark.parametrize("kind", sorted(FILES))
def test_state_dicts_equal_jax_export(exported, kind):
    jax_dst, port_dst = exported[kind]
    name = os.path.basename(port_dst)
    pts = [f"{name}_{tag}.pt" for tag in FILES[kind]]
    if kind != "orced":
        pts.append("discriminator_means.pt")
    assert sorted(os.listdir(port_dst)) == sorted(pts + ["config.pkl"])
    assert sorted(os.listdir(jax_dst)) == sorted(os.listdir(port_dst))
    for fname in pts:
        want = torch.load(os.path.join(jax_dst, fname), map_location="cpu", weights_only=True)
        got = torch.load(os.path.join(port_dst, fname), map_location="cpu", weights_only=True)
        if isinstance(want, torch.Tensor):
            want, got = {"": want}, {"": got}
        assert list(got) == list(want), fname
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (fname, k)
            assert torch.equal(got[k], want[k]), (fname, k)


@pytest.mark.parametrize("kind", ["V4", "orced"])
def test_config_pkl_equal_through_both_unpicklers(exported, kind, monkeypatch):
    monkeypatch.delitem(sys.modules, "constants", raising=False)
    jax_dst, port_dst = exported[kind]
    dicts = []
    for dst in (jax_dst, port_dst):
        for module in (jax_import, port_import):
            d = module.load_reference_config(os.path.join(dst, "config.pkl"))
            d["TRAIN_SCENARIOS"] = [s.value for s in d["TRAIN_SCENARIOS"]]
            dicts.append(d)
    assert all(d == dicts[0] for d in dicts[1:])
    assert ("TRIPLET_W" in dicts[0]) == (kind == "orced")


class TestDetectKind:
    def test_pcaa(self, runs):
        assert port_export.detect_kind(runs["V4"], "EXP_V4.3.0") == "pcaa"

    def test_orced(self, runs):
        assert port_export.detect_kind(runs["orced"], "EXPORCED.4.1") == "orced"


class TestConfigExport:
    def test_pkl_tolerant_unpickle_no_module_leak(self, runs, tmp_path):
        assert "constants" not in sys.modules
        dst = port_export.export_reference_run(runs["V3"], str(tmp_path))
        assert "constants" not in sys.modules
        ref_cfg = port_import.load_reference_config(os.path.join(dst, "config.pkl"))
        assert ref_cfg["MODEL_NAME"] == "EXP_V3.8.0"
        assert ref_cfg["TRAIN_CLASSES"] == [0, 4, 9]
        assert ref_cfg["TRAIN_SCENARIOS"] == list(SCENARIO)
        assert ref_cfg["DEC_MLP_SIZE"] == T * N * C
        assert "TRIPLET_W" not in ref_cfg

    def test_orced_loss_keys_included(self, exported):
        ref_cfg = port_import.load_reference_config(
            os.path.join(exported["orced"][1], "config.pkl"))
        for key in ("TRIPLET_W", "CE_W", "REC_W", "KL_W", "TRIPLET_MARGIN"):
            assert key in ref_cfg, key

    def test_mismatched_folder_name_refused(self, runs, tmp_path):
        renamed = str(tmp_path / "OTHER_NAME")
        shutil.copytree(runs["V3"], renamed)
        for module in (jax_export, port_export):
            with pytest.raises(ValueError, match="does not match"):
                module.export_reference_run(renamed, str(tmp_path / "out"))

    def test_dec_mlp_size_derived_not_stale_field(self, runs, tmp_path):
        """config.pkl's DEC_MLP_SIZE is the shipped decoder's
        NSTEPS·NMAX·NFEATURES, not the Config field nothing keeps."""
        stale = str(tmp_path / "EXP_V1.8.0")
        shutil.copytree(runs["V1"], stale)
        path = os.path.join(stale, "config.json")
        cfg = Config.load(path)
        cfg = cfg.replace(DEC_MLP_SIZE=Config().DEC_MLP_SIZE)
        assert cfg.DEC_MLP_SIZE != cfg.decoder_mlp_size
        cfg.save(path)
        dst = port_export.export_reference_run(stale, str(tmp_path / "out"))
        ref_cfg = port_import.load_reference_config(os.path.join(dst, "config.pkl"))
        assert ref_cfg["DEC_MLP_SIZE"] == T * N * C

    def test_preexisting_constants_module_restored(self, runs, tmp_path):
        assert "constants" not in sys.modules
        caller_mod = types.ModuleType("constants")
        caller_mod.SOME_FLAG = 42
        sys.modules["constants"] = caller_mod
        try:
            port_export.export_reference_run(runs["V3"], str(tmp_path))
            assert sys.modules.get("constants") is caller_mod
        finally:
            sys.modules.pop("constants", None)

    def test_means_of_the_wrong_shape_refused(self, runs, tmp_path):
        bad = str(tmp_path / "EXP_V3.8.0")
        shutil.copytree(runs["V3"], bad)
        np.save(os.path.join(bad, "discriminator_means.npy"), np.zeros((NL + 1, LAT), np.float32))
        for module in (jax_export, port_export):
            with pytest.raises(ValueError, match="discriminator_means shape"):
                module.export_reference_run(bad, str(tmp_path / module.__name__))


class TestPCAARoundTrip:
    def test_reference_folder_contract(self, exported):
        dst = exported["V4"][1]
        for tag in FILES["V4"]:
            assert os.path.exists(os.path.join(dst, f"EXP_V4.3.0_{tag}.pt")), tag
        assert os.path.exists(os.path.join(dst, "discriminator_means.pt"))

    def test_decoder_bn_placeholders(self, exported):
        sd = torch.load(os.path.join(exported["V4"][1], "EXP_V4.3.0_G.pt"), map_location="cpu",
                        weights_only=True)
        size = 12 * 64 * C
        for i, div in zip(range(1, 5), (16, 8, 4, 2)):
            assert sd[f"bn{i}.weight"].shape == (size // div,)
            assert torch.all(sd[f"bn{i}.weight"] == 1)
            assert torch.all(sd[f"bn{i}.running_var"] == 1)

    def test_import_recovers_trees_bitexact(self, runs, exported, tmp_path):
        run, name = runs["V4"], "EXP_V4.3.0"
        cfg = port_import.import_pcaa_run(exported["V4"][1], str(tmp_path))
        assert cfg.MODEL_NAME == name and cfg.TRAIN_CLASSES == (0, 1, 2)
        for tag in FILES["V4"]:
            assert_trees_bitequal(load_params(module_path(cfg.run_dir(), name, tag)),
                                  load_params(module_path(run, name, tag)), tag)
        np.testing.assert_array_equal(
            np.load(os.path.join(cfg.run_dir(), "discriminator_means.npy")),
            np.load(os.path.join(run, "discriminator_means.npy")))


class TestVariantFolderShapes:
    """V3 trains no decoder; V1 also saves its mean learner, next to a GPH
    whose 2·latent projection the decoder reads."""

    def test_v3_shape_no_decoder(self, runs, exported, tmp_path):
        dst = exported["V3"][1]
        assert not os.path.exists(os.path.join(dst, "EXP_V3.8.0_G.pt"))
        enc_sd = torch.load(os.path.join(dst, "EXP_V3.8.0_E.pt"), weights_only=True)
        assert not any(k.startswith("MLP_head") for k in enc_sd)
        cfg = port_import.import_pcaa_run(dst, str(tmp_path))
        assert_trees_bitequal(load_params(module_path(cfg.run_dir(), "EXP_V3.8.0", "E")),
                              load_params(module_path(runs["V3"], "EXP_V3.8.0", "E")), "E")

    def test_v1_shape_with_mean_learner(self, runs, exported, tmp_path):
        cfg = port_import.import_pcaa_run(exported["V1"][1], str(tmp_path))
        for tag in FILES["V1"]:
            assert_trees_bitequal(load_params(module_path(cfg.run_dir(), "EXP_V1.8.0", tag)),
                                  load_params(module_path(runs["V1"], "EXP_V1.8.0", tag)), tag)


class TestORCEDRoundTrip:
    def test_export_import_identity(self, runs, exported, tmp_path):
        cfg = port_import.import_orced_run(exported["orced"][1], str(tmp_path))
        for tag in FILES["orced"]:
            assert_trees_bitequal(load_params(module_path(cfg.run_dir(), "EXPORCED.4.1", tag)),
                                  load_params(module_path(runs["orced"], "EXPORCED.4.1", tag)),
                                  tag)

    def test_cli(self, runs, tmp_path, capsys):
        port_export.main(["--run", runs["orced"], "--out-models", str(tmp_path)])
        assert "[export] wrote" in capsys.readouterr().out
        assert sorted(os.listdir(tmp_path / "EXPORCED.4.1")) == sorted(
            ["config.pkl"] + [f"EXPORCED.4.1_{t}.pt" for t in FILES["orced"]])


# ---------------------------------------------------------------------------
# the transplant maps, bitwise against tools/transplant.py
# ---------------------------------------------------------------------------


def _seeded(tree, rng):
    """``tree`` with every leaf replaced by seeded normal f32 values."""
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(21)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, T, N, C), jnp.float32)
    z0 = jnp.zeros((1, LAT), jnp.float32)
    cg = lambda head: CGEncoder(n_out_labels=NL, sup_latent_dim=LAT,  # noqa: E731
                                use_projection_head=head, **DIMS)
    return {
        "cg_head": _seeded(cg(True).init(key, x0, train=False), rng),
        "cg": _seeded(cg(False).init(key, x0, train=False), rng),
        "orced": _seeded(ORCEDEncoder(n_out_labels=NL, sup_latent_dim=LAT, **DIMS).init(
            {"params": key, "reparam": key}, x0, train=False), rng),
        "dec": _seeded(CGDecoder(nsteps=T, nmax_points=N, nfeatures=C).init(key, z0), rng),
        "ml": _seeded(GaussianMeanLearner(latent_dim=LAT).init(
            key, jnp.eye(NL, dtype=jnp.float32), train=False), rng),
        "disc": _seeded(CGDiscriminator().init(key, z0, jnp.zeros((1, NL), jnp.float32)),
                        rng)["params"],
        "head": _seeded(ProjectionHead(2 * LAT).init(key, z0), rng)["params"],
    }


# map name → its arguments, from the seeded trees (the inverse maps take
# the forward map's state_dict)
MAPS = {
    "cg_encoder_state_dict": lambda t: (t["cg_head"], True),
    "cg_encoder_state_dict/no head": lambda t: (t["cg"], False),
    "orced_encoder_state_dict": lambda t: (t["orced"],),
    "orced_decoder_state_dict": lambda t: (t["dec"], T, N, C),
    "mean_learner_state_dict": lambda t: (t["ml"],),
    "cg_discriminator_state_dict": lambda t: (t["disc"],),
    "sequential_head_state_dict": lambda t: (t["head"],),
    "decoder_bn_placeholder_entries": lambda t: (T * N * C,),
    "decoder_output_permutation": lambda t: (T, N, C),
    "torch_cg_encoder_to_flax": lambda t: (
        jax_transplant.cg_encoder_state_dict(t["cg_head"], True), True),
    "torch_cg_encoder_to_flax/no head": lambda t: (
        jax_transplant.cg_encoder_state_dict(t["cg"], False), False),
    "torch_cg_decoder_to_flax": lambda t: (
        jax_transplant.orced_decoder_state_dict(t["dec"], T, N, C), T, N, C),
    "torch_orced_encoder_to_flax": lambda t: (
        jax_transplant.orced_encoder_state_dict(t["orced"]),),
    "torch_orced_decoder_to_flax": lambda t: (
        jax_transplant.orced_decoder_state_dict(t["dec"], T, N, C), T, N, C),
    "torch_mean_learner_to_flax": lambda t: (jax_transplant.mean_learner_state_dict(t["ml"]),),
    "torch_cg_discriminator_to_flax": lambda t: (
        jax_transplant.cg_discriminator_state_dict(t["disc"]),),
    "torch_sequential_head_to_flax": lambda t: (
        jax_transplant.sequential_head_state_dict(t["head"]),),
}


def _assert_same(got, want, path="out"):
    assert type(got) is type(want), path
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert list(got) == list(want), path  # the same keys in the same order
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("case", sorted(MAPS))
def test_transplant_map_bitwise_equal(trees, case):
    name = case.split("/")[0]
    args = MAPS[case](trees)
    _assert_same(getattr(port_transplant, name)(*args), getattr(jax_transplant, name)(*args))


def test_cli_runs_as_module(runs, tmp_path):
    """``python -m ...scripts.export_reference_run``, then the importer's
    ``python -m``, in fresh interpreters: the ORCED folder comes back with
    the same module files."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = "opensetgaitrecognition_pcaa_tpu_torch.scripts."
    subprocess.run([sys.executable, "-m", pkg + "export_reference_run", "--run", runs["orced"],
                    "--out-models", str(tmp_path / "ref")], cwd=root, check=True,
                   capture_output=True)
    subprocess.run([sys.executable, "-m", pkg + "import_reference_run", "--ref-run",
                    str(tmp_path / "ref" / "EXPORCED.4.1"), "--out-models",
                    str(tmp_path / "back")], cwd=root, check=True, capture_output=True)
    for tag in FILES["orced"]:
        fname = f"EXPORCED.4.1_{tag}.msgpack"
        with open(os.path.join(runs["orced"], fname), "rb") as a, \
                open(tmp_path / "back" / "EXPORCED.4.1" / fname, "rb") as b:
            assert a.read() == b.read(), fname
