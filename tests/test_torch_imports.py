"""The port runs where JAX, flax, msgpack, sklearn and matplotlib are not
installed, and it stands apart from the JAX package and the repository's
root ``scripts/``: importing every one of its modules (the serving
artifact's loader and the command-line drivers among them), or every
module that ``chip_smoke.py`` imports (at its top or inside its
functions), loads none of them."""

import subprocess
import sys
from pathlib import Path

# top-level names; the port's own name starts with the JAX package's, so
# names are compared whole, never as prefixes
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "sklearn", "matplotlib",
             "opensetgaitrecognition_pcaa_tpu", "scripts")

_PORT = """
import importlib, pkgutil
import opensetgaitrecognition_pcaa_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
"""

_SMOKE = """
import ast, importlib
tree = ast.parse(open("chip_smoke.py").read())
names = ["chip_smoke"]
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        names += [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        names.append(node.module)
"""

_REPORT = """
import sys
for name in names:
    importlib.import_module(name)
print(",".join(names))
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
# the serving artifact's loader, the command-line drivers, the grid
# trainers, data and tensor parallelism, the reference run-folder import and
# export and the plotting, each imported by the walk over the port
_ENTRY_MODULES = tuple(
    "opensetgaitrecognition_pcaa_tpu_torch." + m for m in (
        "infer.serving", "parallel.grid", "parallel.mesh", "scripts.run_pcaa_ablation",
        "scripts.run_orced",
        "scripts.run_pointsubsampling", "scripts.run_inference_scenarios",
        "scripts.export_serving", "scripts.collect_results", "scripts.import_reference_run",
        "scripts.export_reference_run", "utils.plotting",
    )
)


def _loaded(script: str, min_modules: int, required=()) -> set:
    """Run ``script`` in a fresh interpreter → the top-level names in
    ``sys.modules`` after it imported its ``names``, which include
    ``required``."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", script + _REPORT], cwd=root, capture_output=True, text=True,
        check=True,
    )
    names, loaded = proc.stdout.strip().splitlines()
    names = names.split(",")
    assert len(names) >= min_modules
    assert not set(required) - set(names), sorted(set(required) - set(names))
    loaded = set(loaded.split(","))
    assert "torch" in loaded and "opensetgaitrecognition_pcaa_tpu_torch" in loaded
    return loaded


def test_port_imports_no_jax_stack():
    loaded = _loaded(_PORT, 55, _ENTRY_MODULES)
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_chip_smoke_imports_no_jax_stack():
    loaded = _loaded(_SMOKE, 20)
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
