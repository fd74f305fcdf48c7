"""A configuration enters the benchmark by new files and appended entries
alone. In a copy of ``benchmark/`` and ``BENCHMARK.json``, a made-up family
``probe`` (the V4 training cell under a model, a family and a kernel part
of its own) is added that way; in the copy, the manifest's tests pass and
a traced run of its cell reports its MFU and the train step's span
metrics; and no file that the copy shares with the checkout differs."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

CELL = "probe.train_b16"
TRAIN_METRICS = ["train_windows_per_s", "train_mfu", "step_idle_ms.train",
                 "epoch_idle_ms.train", "host_syncs_per_step.train"]
ADDED = {
    "benchmark/cells/train_probe.py": '''"""V4 training under the model ``probe``, with a kernel
part of its own."""

from benchmark.cells import train_pcaa
from benchmark.cells.train_pcaa import check, compare, explain, reference  # noqa: F401


class Cell(train_pcaa.Cell):
    def counted(self):
        return {**super().counted(), "probe": 0}
''',
    "benchmark/reference/probe.py": '''"""The probe's parameters: V4's."""

from benchmark.reference.params import pcaa_v4 as leaves  # noqa: F401
''',
    "benchmark/flops/probe.py": '''"""The probe's FLOPs: V4's."""

from benchmark.flops.pcaa import step_flops  # noqa: F401
''',
    "benchmark/kernels/probe.json": '["probe_kernel"]\n',
}
RUN = """
import json, sys, time
import benchmark
from benchmark import harness
from benchmark.tests.conftest import tiny_context
assert benchmark.__file__.startswith({copy!r}), benchmark.__file__
result, _ = harness.run(tiny_context({cell!r}, 2**31 + 77), 0.3, True, time.perf_counter())
print(json.dumps(result))
"""


def add_probe(copy: str) -> None:
    """The probe's new files and its appended entries, in ``copy``."""
    for rel, text in ADDED.items():
        with open(os.path.join(copy, rel), "w") as f:
            f.write(text)
    config = json.load(open(os.path.join(harness.HERE, "configs", "pcaa_v4.json")))
    config.update(name="probe", family="probe", model="probe")
    json.dump(config, open(os.path.join(copy, "benchmark/configs/probe.json"), "w"), indent=2)
    shutil.copy(os.path.join(harness.HERE, "limits", "pcaa_v4.train_b16.json"),
                os.path.join(copy, "benchmark/limits", CELL + ".json"))
    manifest = harness.load_manifest()
    manifest["configs"].append({"name": "probe", "source": "https://arxiv.org/abs/2503.07435",
                                "file": "benchmark/configs/probe.json", "reduced": [],
                                "why": "a made-up family that runs V4"})
    manifest["workloads"].append({"name": CELL, "config": "probe", "traffic": "train_b16",
                                  "chips": 1, "why": "V4 training under a family of its own"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in TRAIN_METRICS:
            m["workloads"].append(CELL)
    json.dump(manifest, open(os.path.join(copy, "BENCHMARK.json"), "w"), indent=1)


def without_probe(manifest):
    manifest["configs"] = [c for c in manifest["configs"] if c["name"] != "probe"]
    manifest["workloads"] = [w for w in manifest["workloads"] if w["name"] != CELL]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return manifest


def files(top):
    return {os.path.relpath(os.path.join(d, f), top) for d, dirs, fs in os.walk(top)
            for f in fs if "__pycache__" not in d}


def test_a_family_enters_by_new_files(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(harness.HERE, os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_probe(copy)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=copy + os.pathsep + harness.ROOT, PYTHONDONTWRITEBYTECODE="1")

    tests = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
                            "benchmark/tests/test_bench_manifest.py"],
                           capture_output=True, text=True, env=env, cwd=copy, timeout=600)
    assert tests.returncode == 0, tests.stdout[-3000:] + tests.stderr[-2000:]
    for case in (f"test_cell[{CELL}]", f"test_counted_parts_have_kernel_files[{CELL}]",
                 f"test_mfu_cells_have_their_familys_flops[train_mfu-{CELL}]"):
        assert f"{case} PASSED" in tests.stdout, case
    run = subprocess.run([sys.executable, "-c", RUN.format(copy=copy, cell=CELL)],
                         capture_output=True, text=True, env=env, cwd=copy, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(TRAIN_METRICS[1:]) <= set(result["metrics"]), result["metrics"]

    mine = files(harness.HERE)
    theirs = files(os.path.join(copy, "benchmark"))
    assert theirs - mine == {os.path.relpath(p, "benchmark") for p in ADDED} | {
        "configs/probe.json", f"limits/{CELL}.json"}
    for rel in mine & theirs:
        assert filecmp.cmp(os.path.join(harness.HERE, rel),
                           os.path.join(copy, "benchmark", rel), shallow=False), rel
    copied = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    assert without_probe(copied) == harness.load_manifest()
