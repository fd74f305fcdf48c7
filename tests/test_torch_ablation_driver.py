"""The port's sequential PCAA ablation driver, end to end at tiny dims.

Mirrors ``tests/test_scripts.py::TestGridDrivers`` for the sequential
mode of ``opensetgaitrecognition_pcaa_tpu_torch/scripts/run_pcaa_ablation.py``
on the CPU: a fresh call trains V1-V4 on one 2-class subset of a
10-subject synthetic raw set; a second call skips all four runs without
writing the splits again, in under ``max(5 s, fresh / 5)``.
``--bf16-weight-cache`` without ``--compute-dtype bfloat16`` fails on the
build's bf16 requirement, as the JAX driver does, in either mode
(``--grid`` is held against the JAX driver in
``tests/test_torch_grid_drivers.py``; the flag at bf16 trains in
``tests/test_torch_bf16_drivers.py``).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import scripts.run_pcaa_ablation as jax_rpa

from opensetgaitrecognition_pcaa_tpu_torch.config import N_SUBJECTS, Config
from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pcaa_ablation as rpa

from tests.test_scripts import TINY

BASE = "PCAA_T_"
FILES = {  # the variant's module files (train/pcaa.py::_checkpoint)
    "V1": ("E", "D", "G", "GPH", "ML"),
    "V2": ("E", "D", "G"),
    "V3": ("E", "D"),
    "V4": ("E", "D", "G", "GPH"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny: one intra-op thread per process keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_default_config(**kw):
    return Config(TRAIN_CLASSES=(0, 1), **{**TINY, **kw})


@pytest.fixture(scope="module")
def raw10(tmp_path_factory):
    """10-subject synthetic raw set: the driver's generate_splits takes the
    reference's N_SUBJECTS = 10."""
    root = tmp_path_factory.mktemp("raw10_port")
    generate_synthetic_raw_dataset(str(root), n_subjects=10, tracks_per_scenario=10,
                                   frames_per_track=(40, 50), seed=3)
    return str(root)


def _argv(raw, td, *extra):
    return ["--data-path", raw, "--gen-data-path", os.path.join(td, "gen"),
            "--models-path", os.path.join(td, "models"), "--model-name-base", BASE,
            "--n-training-classes", "2", "--n-tests", "1", "--device", "cpu", *extra]


def test_sequential_fresh_then_resume(raw10, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(rpa, "default_config", tiny_default_config)
    writes = []
    real = rpa.generate_splits
    monkeypatch.setattr(rpa, "generate_splits", lambda **kw: writes.append(kw) or real(**kw))
    argv = _argv(raw10, str(tmp_path), "--variants", "V1", "V2", "V3", "V4")
    t0 = time.time()
    rpa.main(argv)
    fresh = time.time() - t0
    out1 = capsys.readouterr().out
    t0 = time.time()
    rpa.main(argv)
    resume = time.time() - t0
    out2 = capsys.readouterr().out

    subset = rpa.unique_class_subsets(2, 1, np.random.default_rng(0))[0]
    models = os.path.join(str(tmp_path), "models")
    assert sorted(os.listdir(models)) == [f"{BASE}{v}.2.1" for v in FILES]
    for v, tags in FILES.items():
        name = f"{BASE}{v}.2.1"
        run_dir = os.path.join(models, name)
        assert f"=== training {name} ===" in out1
        assert f"=== skipping completed {name} ===" in out2
        assert set(os.listdir(run_dir)) == {
            "config.json", "metrics.jsonl", "run_complete.json", "discriminator_means.npy",
        } | {f"{name}_{tag}.msgpack" for tag in tags}
        cfg = Config.load(os.path.join(run_dir, "config.json"))
        assert cfg == tiny_default_config().replace(
            DATA_PATH=raw10, GEN_DATA_PATH=os.path.join(str(tmp_path), "gen"),
            MODELS_PATH=models, TRAIN_CLASSES=tuple(subset), SEED=0,
            Openness=openness(2, N_SUBJECTS), MODEL_NAME=name,
            NOTES=f"Ablation run, Variant {v[-1]}")
        with open(os.path.join(run_dir, "run_complete.json")) as f:
            assert np.isfinite(json.load(f)["best_valid_accuracy"])
    assert "=== training" not in out2
    # the splits were written once, for the first call, and never again
    assert [w["train_classes"] for w in writes] == [subset]
    assert resume < max(5.0, fresh / 5), (fresh, resume)


def test_class_subsets_equal_the_jax_driver_s():
    for n_tr, n_tests in ((2, 5), (4, 5), (8, 5), (9, 10)):
        assert (rpa.unique_class_subsets(n_tr, n_tests, np.random.default_rng(0))
                == jax_rpa.unique_class_subsets(n_tr, n_tests, np.random.default_rng(0)))


@pytest.mark.parametrize(
    "extra,match",
    [(["--grid", "--bf16-weight-cache"], "would CHANGE numerics"),
     (["--bf16-weight-cache"], "would CHANGE numerics")],
    ids=["grid", "bf16_weight_cache"],
)
def test_unported_modes_raise(raw10, tmp_path, monkeypatch, extra, match):
    """``--bf16-weight-cache`` at f32 compute: the run fails on the build's
    bf16 requirement (JAX ``build_pcaa``'s refusal), in the sequential and
    the ``--grid`` mode, after the splits are written, as in JAX, and
    before any run folder is."""
    monkeypatch.setattr(rpa, "default_config", tiny_default_config)
    with pytest.raises(ValueError, match=match):
        rpa.main(_argv(raw10, str(tmp_path), "--variants", "V4", *extra))
    gen = [d for d in os.listdir(tmp_path) if d.startswith("gen")]
    assert gen and all(os.listdir(tmp_path / d) for d in gen)
    models = tmp_path / "models"
    assert not models.exists() or not any(
        os.path.exists(models / run / "run_complete.json") for run in os.listdir(models))


def test_runs_as_a_module():
    """``python -m`` finds the driver; its default device is the card."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation",
         "--help"], cwd=root, capture_output=True, text=True, check=True,
    )
    assert "--device" in proc.stdout and "--grid" in proc.stdout
    assert rpa._parser().parse_args(["--data-path", "x"]).device == "cuda"
