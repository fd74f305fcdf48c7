"""Nothing the harness, its cell modules, metrics and reference import has the
top-level name of JAX, flax or the JAX package (compared whole: the
program's name starts with the JAX package's), and the reference imports
nothing of the program either. Each in a fresh interpreter."""

import os
import subprocess
import sys

from benchmark import harness

SCRIPT = """
import glob, os, sys
sys.path.insert(0, {root!r})
import benchmark.reference.model, benchmark.reference.params, benchmark.reference.centroids
ref_only = {{m.split(".")[0] for m in sys.modules}}
assert "opensetgaitrecognition_pcaa_tpu_torch" not in ref_only, "the reference imports the program"
import benchmark.harness as h, benchmark.run, benchmark.calibrate, benchmark.tracing
for path in glob.glob(os.path.join(h.HERE, "cells", "*.py")):
    __import__("benchmark.cells." + os.path.basename(path)[:-3])
for path in glob.glob(os.path.join(h.HERE, "metrics", "*.py")):
    h.metric_reader(os.path.basename(path)[:-3])
import opensetgaitrecognition_pcaa_tpu_torch.train.pcaa, opensetgaitrecognition_pcaa_tpu_torch.train.orced
import opensetgaitrecognition_pcaa_tpu_torch.infer.serving
assert "opensetgaitrecognition_pcaa_tpu_torch" in {{m.split(".")[0] for m in sys.modules}}
found = h.forbidden_modules()
assert not found, found
print("clean")
"""


def test_whole_top_level_names():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=harness.ROOT)],
                         capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def test_rule_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "opensetgaitrecognition_pcaa_tpu_torch_x", sys)
    assert "opensetgaitrecognition_pcaa_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "opensetgaitrecognition_pcaa_tpu.config", sys)
    assert harness.forbidden_modules() == ["opensetgaitrecognition_pcaa_tpu"]
