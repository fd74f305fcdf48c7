"""The ``--grid`` mode of the port's ``run_pcaa_ablation`` and ``run_orced``
against the JAX drivers' ``--grid`` on the same raw tracks, on the CPU.

Each JAX driver runs once (a module fixture), at ``tests/test_scripts.py``'s
TINY dims, on a 10-subject synthetic raw set, with ``--n-training-classes
2 --n-tests 2`` (the PCAA driver with V1 and V4); its outputs are moved
aside and the port's driver then runs in the same directory with the same
relative paths, so that the two write the same ``config.json`` bytes. Both
must give the same run folders, the same file names in each, byte-equal
``config.json``, ``metrics.jsonl`` with the same keys and line count,
``run_complete.json`` with the same keys, the same split directories and
the same ``=== grid-training`` lines. A second call of the port's driver
skips both splits without writing one.
"""

import contextlib
import io
import json
import os
import sys

import pytest

import scripts.run_orced as jax_orced
import scripts.run_pcaa_ablation as jax_rpa

from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_orced, run_pcaa_ablation
from tests.test_scripts import tiny_default_config as jax_tiny_default_config
from tests.test_torch_drivers import (  # noqa: F401
    one_torch_thread,
    raw10,
    tiny_default_config,
)

# driver → (JAX module, port module, path prefix, extra flags)
DRIVERS = {
    "run_pcaa_ablation": (jax_rpa, run_pcaa_ablation, "p", ["--variants", "V1", "V4"]),
    "run_orced": (jax_orced, run_orced, "o", []),
}


def _argv(raw, prefix, extra):
    return ["--data-path", raw, "--gen-data-path", f"{prefix}g", "--models-path",
            f"{prefix}m", "--n-training-classes", "2", "--n-tests", "2", "--grid", *extra]


@pytest.fixture(scope="module")
def jax_grids(raw10, tmp_path_factory):  # noqa: F811
    """Each JAX driver's ``--grid`` run → (directory, {driver: stdout});
    its outputs renamed with a ``jax_`` prefix."""
    root = tmp_path_factory.mktemp("grid_drivers")
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        for name, (module, _, prefix, extra) in DRIVERS.items():
            mp.setattr(module, "default_config", jax_tiny_default_config)
            mp.setattr(sys, "argv", [name, *_argv(raw10, prefix, extra)])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                module.main()
            outs[name] = buf.getvalue()
            for d in os.listdir(root):
                if d.startswith(prefix):
                    os.rename(d, "jax_" + d)
    return str(root), outs


def _tree(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, files in os.walk(top) for f in files)


def _lines(out, start):
    return [line for line in out.splitlines() if line.startswith(start)]


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_grid_writes_the_jax_driver_s_files(driver, jax_grids, raw10, monkeypatch,  # noqa: F811
                                            capsys):
    root, jax_out = jax_grids
    _, port, prefix, extra = DRIVERS[driver]
    monkeypatch.chdir(root)
    monkeypatch.setattr(port, "default_config", tiny_default_config)
    argv = _argv(raw10, prefix, extra) + ["--device", "cpu"]
    port.main(argv)
    out = capsys.readouterr().out

    models, jax_models = f"{prefix}m", f"jax_{prefix}m"
    runs = sorted(os.listdir(models))
    assert runs == sorted(os.listdir(jax_models))
    assert len(runs) == (4 if driver == "run_pcaa_ablation" else 2)
    for run in runs:
        ours, theirs = os.path.join(models, run), os.path.join(jax_models, run)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)), run
        with open(os.path.join(ours, "config.json"), "rb") as a, \
                open(os.path.join(theirs, "config.json"), "rb") as b:
            assert a.read() == b.read(), run
        logs = []
        for d in (ours, theirs):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                logs.append([sorted(json.loads(line)) for line in f])
        assert logs[0] == logs[1] and len(logs[0]) == 1, run
        done = []
        for d in (ours, theirs):
            with open(os.path.join(d, "run_complete.json")) as f:
                done.append(json.load(f))
        assert sorted(done[0]) == sorted(done[1]) == ["best_valid_accuracy"]
    splits = sorted(d for d in os.listdir(".") if d.startswith(f"{prefix}g"))
    assert splits == sorted(d[4:] for d in os.listdir(".") if d.startswith(f"jax_{prefix}g"))
    assert len(splits) == 2
    for d in splits:
        assert _tree(d) == _tree("jax_" + d)
    assert _lines(out, "=== grid-training") == _lines(jax_out[driver], "=== grid-training")

    # a second call skips both splits before writing any
    writes = []
    monkeypatch.setattr(port, "generate_splits", lambda **kw: writes.append(kw))
    port.main(argv)
    out2 = capsys.readouterr().out
    assert _lines(out2, "    skipping completed splits [1, 2]")
    assert not writes and "=== grid-training" not in out2
