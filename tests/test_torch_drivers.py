"""The port's sequential drivers ``run_orced``, ``run_pointsubsampling``,
``run_inference_scenarios`` and its copy of ``collect_results``, against
the JAX package's drivers, on the CPU.

- With the trainers, ``pcaa_inference`` and ``generate_splits`` of both
  packages replaced by recorders (nothing trains), each port driver makes
  the JAX driver's calls in the JAX driver's order, with equal
  configurations and arguments, at the default flags and at another set;
  the port's calls add ``device`` and nothing else.
- At ``tests/test_scripts.py``'s TINY dims on a 10-subject synthetic raw
  set, ``run_orced`` and ``run_pointsubsampling`` train and score fresh; a
  second call trains nothing and writes no split; a point-count run that is
  trained but not scored is scored again without training.
- ``run_inference_scenarios`` writes the JAX driver's files, with its F1
  values, on one run folder.
- The results table equals the root ``collect_results``'s.
"""

import enum
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.collect_results as jax_collect
import scripts.run_inference_scenarios as jax_scenarios
import scripts.run_orced as jax_orced
import scripts.run_pointsubsampling as jax_points
from opensetgaitrecognition_pcaa_tpu.models import CGEncoder as FlaxCGEncoder
from opensetgaitrecognition_pcaa_tpu.train.run_folder import module_path, save_params

from opensetgaitrecognition_pcaa_tpu_torch.config import (
    N_SUBJECTS,
    SCENARIO,
    SPLIT,
    VARIATION,
    Config,
)
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
    calibrate_open_set,
    pcaa_inference_setup,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.scripts import collect_results
from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_inference_scenarios as scenarios
from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_orced
from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pointsubsampling as points
from opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation import unique_class_subsets

from tests.test_scripts import TINY
from tests.test_torch_models import flax_encoder_vars

DRIVERS = {  # driver → (JAX module, port module, the functions it calls)
    "run_orced": (jax_orced, run_orced, ("generate_splits", "train_orced")),
    "run_pointsubsampling": (jax_points, points, ("generate_splits", "train_pcaa",
                                                  "pcaa_inference")),
    "run_inference_scenarios": (jax_scenarios, scenarios, ("pcaa_inference",)),
}
FLAGS = {  # driver → (default flags, another set)
    "run_orced": (
        ["--data-path", "raw"],
        ["--data-path", "raw", "--gen-data-path", "g", "--models-path", "m",
         "--model-name-base", "OR_", "--n-training-classes", "3", "7", "--n-tests", "2",
         "--epochs", "4", "--wandb-mode", "offline", "--compute-dtype", "float32",
         "--no-skip-completed"],
    ),
    "run_pointsubsampling": (
        ["--data-path", "raw"],
        ["--data-path", "raw", "--gen-data-path", "g", "--models-path", "m",
         "--figures-path", "f", "--model-name-base", "NP_", "--n-training-classes", "4",
         "--n-points-subs", "70", "130", "--n-tests", "2", "--ks", "2", "6", "--epochs", "3",
         "--no-skip-completed"],
    ),
    "run_inference_scenarios": (
        ["--data-path", "raw", "--model-names", "A_V4.2.1"],
        ["--data-path", "raw", "--models-path", "m", "--figures-path", "f",
         "--model-names", "A_V4.2.1", "B_V1.4.2", "--ks", "2", "1", "--no-generate-dataset"],
    ),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny: one intra-op thread per process keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw10(tmp_path_factory):
    """10-subject synthetic raw set: the scripts' generate_splits take the
    reference's N_SUBJECTS = 10."""
    root = tmp_path_factory.mktemp("raw10_drivers")
    generate_synthetic_raw_dataset(str(root), n_subjects=10, tracks_per_scenario=10,
                                   frames_per_track=(40, 50), seed=3)
    return str(root)


def tiny_default_config(**kw):
    return Config(TRAIN_CLASSES=(0, 1), **{**TINY, **kw})


# --- the same calls as the JAX drivers -------------------------------------------


def _shared(value):
    """A recorded argument in a form both packages' values share."""
    if hasattr(value, "to_dict"):  # a Config of either package
        return json.dumps(value.to_dict(), sort_keys=True, default=str)
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_shared(v) for v in value]
    return value


def _record(module, names, monkeypatch) -> list:
    calls = []
    for name in names:
        def recorder(*args, _name=name, **kwargs):
            calls.append((_name, _shared(args), {k: _shared(v) for k, v in kwargs.items()}))
            return {"best_valid_accuracy": 0.5, "windows_per_sec": 1.0}

        monkeypatch.setattr(module, name, recorder)
    return calls


@pytest.mark.parametrize("flags", ["default", "other"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_makes_the_jax_driver_s_calls(driver, flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jax_module, port_module, names = DRIVERS[driver]
    argv = FLAGS[driver][flags == "other"]
    want = _record(jax_module, names, monkeypatch)
    monkeypatch.setattr(sys, "argv", [driver, *argv])
    jax_module.main()
    got = _record(port_module, names, monkeypatch)
    device = "cuda" if flags == "default" else "cpu"
    port_module.main(argv + (["--device", "cpu"] if flags == "other" else []))
    for name, _, kwargs in got:
        if name != "generate_splits":
            assert kwargs.pop("device") == device, name
    assert len(want) > 0 and got == want
    assert not os.listdir(tmp_path)


# --- fresh, then resumed -------------------------------------------------------------


def _argv(raw, td, *extra):
    return ["--data-path", raw, "--gen-data-path", os.path.join(td, "gen"),
            "--models-path", os.path.join(td, "models"), "--n-training-classes", "2",
            "--n-tests", "1", "--device", "cpu", *extra]


def _count_splits(module, monkeypatch) -> list:
    writes = []
    real = module.generate_splits
    monkeypatch.setattr(module, "generate_splits",
                        lambda **kw: writes.append(kw["nmax_points"]) or real(**kw))
    return writes


def test_run_orced_fresh_then_resumed(raw10, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run_orced, "default_config", tiny_default_config)
    writes = _count_splits(run_orced, monkeypatch)
    argv = _argv(raw10, str(tmp_path), "--model-name-base", "ORCED_T")
    run_orced.main(argv)
    out1 = capsys.readouterr().out
    run_orced.main(argv)
    out2 = capsys.readouterr().out

    name = "ORCED_T.2.1"
    models = os.path.join(str(tmp_path), "models")
    run_dir = os.path.join(models, name)
    assert os.listdir(models) == [name]
    assert f"=== training {name} ===" in out1 and "best_valid_acc=" in out1
    assert f"=== skipping completed {name} ===" in out2 and "=== training" not in out2
    assert set(os.listdir(run_dir)) == {"config.json", "metrics.jsonl", "run_complete.json"} | {
        f"{name}_{tag}.msgpack" for tag in ("E", "G", "ML")}
    subset = unique_class_subsets(2, 1, np.random.default_rng(0))[0]
    assert Config.load(os.path.join(run_dir, "config.json")) == tiny_default_config().replace(
        DATA_PATH=raw10, GEN_DATA_PATH=os.path.join(str(tmp_path), "gen"), MODELS_PATH=models,
        TRIPLET_W=1.0, CE_W=1.0, REC_W=1.0, KL_W=1.0, TRIPLET_MARGIN=0.5, MODEL_NAME=name,
        TRAIN_CLASSES=tuple(subset), Openness=openness(2, N_SUBJECTS), SEED=0,
        NOTES="ORCED grid run")
    assert writes == [TINY["NMAX"]]  # the first call's, and no other


def test_run_pointsubsampling_fresh_resumed_and_rescored(raw10, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(points, "default_config", tiny_default_config)
    writes = _count_splits(points, monkeypatch)
    argv = _argv(raw10, str(tmp_path), "--model-name-base", "NP_V4_", "--n-points-subs",
                 "20", "24", "--ks", "1", "2", "--epochs", "1",
                 "--figures-path", os.path.join(str(tmp_path), "figures"))
    names = ["NP_V4_20.2.1", "NP_V4_24.2.1"]
    models = os.path.join(str(tmp_path), "models")
    points.main(argv)
    out1 = capsys.readouterr().out
    assert writes == [20, 24]
    for n_points, name in zip((20, 24), names):
        run_dir = os.path.join(models, name)
        assert f"=== training {name} ===" in out1
        for k in (1, 2):
            with open(os.path.join(run_dir, f"naive_seq_log_{k}.json")) as f:
                assert np.isfinite(json.load(f)["f1_micro"])
        cfg = Config.load(os.path.join(run_dir, "config.json"))
        assert (cfg.NMAX, cfg.SEED, cfg.MODEL_NAME) == (n_points, 0, name)
        assert cfg.NOTES == f"Runs with different number of points ({n_points}.2.1)"

    points.main(argv)
    out2 = capsys.readouterr().out
    assert all(f"=== skipping completed {n} ===" in out2 for n in names)
    assert writes == [20, 24]

    # trained but not scored: its splits are written again and it is scored
    # without training
    e_file = module_path(os.path.join(models, names[0]), names[0], "E")
    mtime = os.stat(e_file).st_mtime_ns
    log = os.path.join(models, names[0], "naive_seq_log_2.json")
    os.remove(log)
    points.main(argv)
    out3 = capsys.readouterr().out
    assert f"=== re-running inference for {names[0]} ===" in out3
    assert f"=== skipping completed {names[1]} ===" in out3 and "=== training" not in out3
    assert os.path.exists(log) and os.stat(e_file).st_mtime_ns == mtime
    assert writes == [20, 24, 20]


# --- per-scenario logs --------------------------------------------------------------


@pytest.fixture(scope="module")
def scenario_run(raw10, tmp_path_factory):
    """A V4 run folder from a flax init over raw10's splits at TINY dims →
    (models_path, name). The centres are ten times the train classes' mean
    latents: the scores spread, and no crop's lies within 1e-4 of a
    scenario's threshold (the test asserts it)."""
    root = tmp_path_factory.mktemp("scenario_run")
    gen, models, name = str(root / "gen"), str(root / "models"), "SCN_V4.3.1"
    generate_splits(data_path=raw10, gen_data_path=gen, train_classes=[0, 1, 2], seed=0,
                    nmax_points=TINY["NMAX"], nsteps=TINY["NSTEPS"],
                    crop_step=TINY["CROP_STEP"], verbose=False)
    cfg = Config(GEN_DATA_PATH=gen, DATA_PATH=raw10, MODELS_PATH=models, MODEL_NAME=name,
                 TRAIN_CLASSES=(0, 1, 2), **TINY)
    run_dir = os.path.join(models, name)
    cfg.save(os.path.join(run_dir, "config.json"))
    x, y = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    enc = FlaxCGEncoder(n_out_labels=3, sup_latent_dim=cfg.SUP_LATENT_DIM,
                        pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=cfg.DTC_FILTERS,
                        use_projection_head=True)
    enc_vars = flax_encoder_vars(enc, x[:16], seed=1, steps=30)
    save_params(enc_vars, module_path(run_dir, name, "E"))
    _, fv = enc.apply(enc_vars, jnp.asarray(x), train=False)
    means = 10 * np.stack([np.asarray(fv)[y == c].mean(axis=0) for c in range(3)])
    np.save(os.path.join(run_dir, "discriminator_means.npy"), means.astype(np.float32))
    return models, name


def test_run_inference_scenarios_writes_the_jax_driver_s_logs(scenario_run, raw10, tmp_path,
                                                              monkeypatch):
    src, name = scenario_run
    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(tmp_path / side)
        shutil.copytree(os.path.join(src, name), os.path.join(paths[side], name))
    argv = ["--data-path", raw10, "--model-names", name, "--ks", "2", "1",
            "--no-generate-dataset"]
    monkeypatch.setattr(sys, "argv", ["run_inference_scenarios", *argv, "--models-path",
                                      paths["jax"], "--figures-path", str(tmp_path / "fj")])
    jax_scenarios.main()
    scenarios.main([*argv, "--models-path", paths["port"], "--figures-path",
                    str(tmp_path / "fp"), "--device", "cpu"])

    files = {side: sorted(os.listdir(os.path.join(p, name))) for side, p in paths.items()}
    assert files["port"] == files["jax"]
    for s in SCENARIO:
        for k in (2, 1):
            stem = f"naive_seq_log_{k}_scenarios{s.value}.json"
            assert stem in files["port"]
            logs = {}
            for side, p in paths.items():
                with open(os.path.join(p, name, stem)) as f:
                    logs[side] = json.load(f)
            assert all(np.isfinite(logs["port"][m]) for m in ("f1_micro", "f1_macro"))
            assert logs["port"] == logs["jax"], (s, k)
    # no crop's score within 1e-4 of its scenario's threshold, so that the
    # f32 gap between the two encoders cannot flip a decision
    cfg, encoder, means = pcaa_inference_setup(name, VARIATION.V4, device="cpu",
                                               models_path=paths["port"], generate_dataset=False)
    for s in SCENARIO:
        cal = calibrate_open_set(encoder, means, cfg, device="cpu", scenarios_list=[s])
        scores = np.concatenate([cal.test_ll, cal.unseen_ll])
        others = scores[scores != cal.log_threshold]
        assert np.abs(others - cal.log_threshold).min() > 1e-4, s


# --- the results table -----------------------------------------------------------------


def test_collect_results_equals_the_root_one(tmp_path):
    models = tmp_path / "models"
    logs = {
        "PCAA_T_V1.2.1": {"naive_seq_log_1.json": 0.5, "naive_seq_log_2.json": 0.625},
        "PCAA_T_V1.2.2": {"naive_seq_log_1.json": 0.75, "naive_seq_log_2.json": 0.125},
        "PCAA_T_V4.4.1": {"naive_seq_log_6.json": 0.25,
                          "naive_seq_log_6_scenariosfree_walk.json": 1.0},
        "ORCED_.4.1": {"ensemble_ood_log.json": 0.375},
        "loose_run": {"naive_seq_log_1.json": 0.875},
        "empty_run": {},
    }
    for run, files in logs.items():
        os.makedirs(models / run)
        for stem, value in files.items():
            (models / run / stem).write_text(json.dumps(
                {"accuracy": value, "f1_micro": value / 2, "f1_macro": value / 4,
                 "f1_weighted": value / 8, "n_steps": 1}))
    (models / "notes.txt").write_text("not a run")
    rows = collect_results.collect(str(models))
    assert rows == jax_collect.collect(str(models)) and len(rows) == 7
    assert collect_results.to_markdown(rows) == jax_collect.to_markdown(rows)
    outs = {}
    for side, module in (("jax", jax_collect), ("port", collect_results)):
        md, js = str(tmp_path / f"{side}.md"), str(tmp_path / f"{side}.json")
        argv = ["--models-path", str(models), "--markdown", md, "--json", js]
        if side == "jax":
            sys_argv = sys.argv
            sys.argv = ["collect_results", *argv]
            try:
                module.main()
            finally:
                sys.argv = sys_argv
        else:
            module.main(argv)
        outs[side] = (open(md).read(), open(js).read())
    assert outs["port"] == outs["jax"]


# --- options and modules ------------------------------------------------------------------


@pytest.mark.parametrize(
    "extra,match",
    [(["--grid", "--bf16-weight-cache"], "would CHANGE numerics"),
     (["--bf16-weight-cache"], "would CHANGE numerics")],
    ids=["grid", "bf16_weight_cache"],
)
def test_run_orced_unported_modes_raise(raw10, tmp_path, monkeypatch, extra, match):
    """``--bf16-weight-cache`` at f32 compute: the run fails on the build's
    bf16 requirement (JAX ``build_orced``'s refusal), in the sequential and
    the ``--grid`` mode, after the splits are written, as in JAX, and
    before any run folder is (the flag at bf16 trains in
    ``tests/test_torch_bf16_drivers.py``)."""
    monkeypatch.setattr(run_orced, "default_config", tiny_default_config)
    with pytest.raises(ValueError, match=match):
        run_orced.main(_argv(raw10, str(tmp_path), *extra))
    gen = [d for d in os.listdir(tmp_path) if d.startswith("gen")]
    assert gen and all(os.listdir(tmp_path / d) for d in gen)
    models = tmp_path / "models"
    assert not models.exists() or not any(
        os.path.exists(models / run / "run_complete.json") for run in os.listdir(models))


@pytest.mark.parametrize("module", ["run_orced", "run_pointsubsampling",
                                    "run_inference_scenarios", "collect_results"])
def test_driver_runs_as_a_module(module):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", f"opensetgaitrecognition_pcaa_tpu_torch.scripts.{module}",
         "--help"], cwd=root, capture_output=True, text=True, check=True,
    )
    assert "--models-path" in proc.stdout
    if module != "collect_results":
        port = {"run_orced": run_orced, "run_pointsubsampling": points,
                "run_inference_scenarios": scenarios}[module]
        args = port._parser().parse_args(["--data-path", "x", "--model-names", "a"]
                                         if module == "run_inference_scenarios"
                                         else ["--data-path", "x"])
        assert args.device == "cuda" and "--device" in proc.stdout
