"""The drivers' bf16 flags: ``run_pcaa_ablation`` and ``run_orced`` with
``--compute-dtype bfloat16`` (and ``--bf16-adam-nu``) make the JAX
drivers' calls with the same flags, configurations included, and
``--grid`` hands ``run_grid_mode`` the configuration with the flags
applied; a bf16 ablation trains end to end at tiny dims on the CPU and
writes f32 module files that the port's inference reads;
``--bf16-weight-cache`` with ``--compute-dtype bfloat16`` trains in both
drivers and both modes, and its module files are bitwise those of the
same call without the flag (the cache changes no bit), while without
``--compute-dtype bfloat16`` the build refuses it, as in JAX.
"""

import os
import sys

import numpy as np
import pytest

import scripts.run_orced as jax_orced
import scripts.run_pcaa_ablation as jax_rpa

from opensetgaitrecognition_pcaa_tpu_torch.config import Config
from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_orced, run_pcaa_ablation
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params
from tests.test_scripts import TINY
from tests.test_torch_drivers import _record, one_torch_thread, raw10  # noqa: F401

DRIVERS = {  # driver → (JAX module, port module, the functions it calls)
    "run_pcaa_ablation": (jax_rpa, run_pcaa_ablation, ("generate_splits", "train_pcaa")),
    "run_orced": (jax_orced, run_orced, ("generate_splits", "train_orced")),
}


@pytest.mark.parametrize("flags", [["--compute-dtype", "bfloat16"],
                                   ["--compute-dtype", "bfloat16", "--bf16-adam-nu"],
                                   ["--bf16-adam-nu"]],
                         ids=["bf16", "bf16_adam_nu", "f32_adam_nu"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_bf16_flags_make_the_jax_driver_s_calls(driver, flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jax_module, port_module, names = DRIVERS[driver]
    argv = ["--data-path", "raw", "--n-training-classes", "3", "--n-tests", "2", *flags]
    want = _record(jax_module, names, monkeypatch)
    monkeypatch.setattr(sys, "argv", [driver, *argv])
    jax_module.main()
    got = _record(port_module, names, monkeypatch)
    port_module.main(argv + ["--device", "cpu"])
    trains = [kw for name, _, kw in got if name.startswith("train_")]
    for kwargs in trains:
        assert kwargs.pop("device") == "cpu"
    assert len(trains) > 0 and got == want
    configs = [args[0] for name, args, _ in got if name.startswith("train_")]
    dtype = "bfloat16" if "bfloat16" in flags else "float32"
    assert all(f'"COMPUTE_DTYPE": "{dtype}"' in c for c in configs)
    assert all(f'"BF16_ADAM_NU": {str("--bf16-adam-nu" in flags).lower()}' in c
               for c in configs)


def _module_files(models: str) -> dict:
    """{run/file: bytes} of the module files under a models path."""
    out = {}
    for run in sorted(os.listdir(models)):
        for f in sorted(os.listdir(os.path.join(models, run))):
            if f.endswith(".msgpack"):
                with open(os.path.join(models, run, f), "rb") as fh:
                    out[f"{run}/{f}"] = fh.read()
    return out


@pytest.mark.parametrize("extra,match", [(["--grid", "--bf16-weight-cache"],
                                          "would CHANGE numerics"),
                                         (["--bf16-weight-cache"], "would CHANGE numerics"),
                                         (["--compute-dtype", "bfloat16", "--bf16-weight-cache"],
                                          None),
                                         (["--grid", "--compute-dtype", "bfloat16",
                                           "--bf16-weight-cache"], None)],
                         ids=["grid", "bf16_weight_cache", "bf16_with_cache", "grid_bf16_with_cache"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_unported_modes_still_raise(driver, extra, match, raw10, tmp_path,  # noqa: F811
                                    monkeypatch):
    """``--bf16-weight-cache``: at f32 compute the build refuses it with JAX's
    words (after the splits are written, as in JAX); at bf16 one V4 (or
    ORCED) run of 1 epoch at tiny dims trains, sequentially or as a grid,
    and its module files are bitwise those of the same call without the
    flag."""
    module = DRIVERS[driver][1]
    monkeypatch.setattr(module, "default_config",
                        lambda **kw: Config(TRAIN_CLASSES=(0, 1), **{**TINY, **kw}))

    def argv(models, flags):
        out = ["--data-path", raw10, "--gen-data-path", str(tmp_path / "gen"),
               "--models-path", str(tmp_path / models), "--n-training-classes", "2",
               "--n-tests", "1", "--epochs", "1", "--device", "cpu", *flags]
        return out + (["--variants", "V4"] if driver == "run_pcaa_ablation" else [])

    if match is not None:
        with pytest.raises(ValueError, match=match):
            module.main(argv("m", extra))
        assert not os.path.exists(tmp_path / "m") or not any(
            os.path.exists(tmp_path / "m" / run / "run_complete.json")
            for run in os.listdir(tmp_path / "m"))
        return
    module.main(argv("on", extra))
    module.main(argv("off", [f for f in extra if f != "--bf16-weight-cache"]))
    on, off = _module_files(str(tmp_path / "on")), _module_files(str(tmp_path / "off"))
    assert on and on.keys() == off.keys()
    for f in on:
        assert on[f] == off[f], f
    run = sorted(os.listdir(tmp_path / "on"))[0]
    cfg = Config.load(os.path.join(tmp_path / "on", run, "config.json"))
    assert cfg.BF16_WEIGHT_CACHE and cfg.COMPUTE_DTYPE == "bfloat16"


@pytest.mark.parametrize("flags", [["--compute-dtype", "bfloat16", "--bf16-adam-nu"],
                                   ["--bf16-adam-nu"], []],
                         ids=["bf16_adam_nu", "f32_adam_nu", "f32"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_grid_mode_gets_the_precision_flags(driver, flags, monkeypatch):
    """``--grid`` hands ``run_grid_mode`` the sequential mode's base
    configuration: the flags and ``--epochs`` applied."""
    module = DRIVERS[driver][1]
    got = []
    monkeypatch.setattr(module, "run_grid_mode", lambda args, cfg: got.append((args, cfg)))
    module.main(["--data-path", "raw", "--grid", "--epochs", "3", "--device", "cpu", *flags])
    (args, cfg), = got
    assert args.grid and args.device == "cpu" and cfg.EPOCHS == 3
    assert cfg.COMPUTE_DTYPE == ("bfloat16" if "bfloat16" in flags else "float32")
    assert cfg.BF16_ADAM_NU == ("--bf16-adam-nu" in flags)


def test_bf16_ablation_trains_and_writes_f32_files(raw10, tmp_path, monkeypatch):  # noqa: F811
    """One bf16 + nu16 V4 run through the driver, 1 epoch at tiny dims: the
    run's config says bf16, its module files hold f32 weights."""
    monkeypatch.setattr(run_pcaa_ablation, "default_config",
                        lambda **kw: Config(TRAIN_CLASSES=(0, 1), **{**TINY, **kw}))
    models = str(tmp_path / "models")
    run_pcaa_ablation.main(["--data-path", raw10, "--gen-data-path", str(tmp_path / "gen"),
                            "--models-path", models, "--n-training-classes", "2",
                            "--n-tests", "1", "--variants", "V4", "--epochs", "1",
                            "--compute-dtype", "bfloat16", "--bf16-adam-nu", "--device", "cpu"])
    name = "PCAA_Abl2_V4.2.1"
    cfg = Config.load(os.path.join(models, name, "config.json"))
    assert cfg.COMPUTE_DTYPE == "bfloat16" and cfg.BF16_ADAM_NU
    enc = load_params(os.path.join(models, name, f"{name}_E.msgpack"))
    kernel = enc["params"]["GaitBackbone_0"]["PointNetBlock_0"]["TorchDense_0"]["kernel"]
    assert isinstance(kernel, np.ndarray) and kernel.dtype == np.float32
    assert np.isfinite(kernel).all()
