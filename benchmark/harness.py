"""One run of one cell: set-up, the measured window (or a traced segment),
the peak memory, the comparison with the plain reference, the result line.

A cell (``workloads`` of ``BENCHMARK.json``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<mix>.json``); the mix's ``mode`` and the
configuration's ``family`` pick the cell module ``benchmark/cells/
<mode>_<family>.py``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``; each cell's limits of the comparison are
``benchmark/limits/<cell>.json``.

A cell module has ``Cell(ctx)``, whose construction is the cell's
set-up (build, weights and inputs from the seed, warm-up, and the program's
readings that the comparison needs), and whose methods are
``window(deadline) → work``, ``segment() → work`` (a fixed steady part, for
the trace), ``end_to_end(work, seconds) → {metric: value}``,
``attempted() → (attempted, failed)``, ``counted()`` (the program's launch
counters by kernel part), ``info()`` (what the metric readers need of the
cell: its ``dims``, ``batch``, ``family`` and ``n_classes``),
``readings()`` and ``free()``; and ``reference(ctx, readings, exact)``,
``compare(program, reference) → [(name, value)]`` and ``check(ctx,
readings) → [(name, value, limit)]``, which runs the reference.

A traced run (``--trace 1``) runs half the window untraced, then the
segment under ``tracing.traced`` (device activity, whose times the
``device_trace`` metrics and ``busy_s``, ``window_s`` and ``breakdown``
read, and a pass with the host's ops) and once more inside the program's
recorder (``program.traced_program``), whose spans and counters the
``program_span`` and ``program_counter`` metrics read.

How a configuration enters: by new files, and by entries appended to
``BENCHMARK.json``; no file the benchmark has is edited.

- ``configs/<config>.json``: the sizes as run, with ``family`` and
  ``model``, and its entry under ``configs``;
- ``traffic/<mix>.json``, where the mix is new (the general generator in
  ``traffic.py`` reads it);
- ``cells/<mode>_<family>.py``, where the family is new: the cell module
  above, with its plain reference beside it;
- ``reference/<model>.py`` with ``leaves(dims, n_classes)``: the model's
  parameters by name, shape and range (``reference/params.py::leaves``);
- ``flops/<family>.py`` with ``step_flops(dims, batch, n_classes)`` and,
  for an eval cell, ``crop_flops(dims, n_classes)``: what ``train_mfu``
  and ``eval_mfu`` count;
- ``kernels/<part>.json`` for each key of ``counted()`` that is new: the
  name fragments of the part's kernels (``tracing.PORT_KERNELS``);
- ``limits/<cell>.json``: the limits of the comparison;
- ``metrics/<metric>.py`` for each new per-layer metric, and its entry
  under ``per_layer``.

The cell goes under ``workloads``, and its name is appended to the
``workloads`` list of each metric it reports; those lists are the only
existing entries it touches.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "opensetgaitrecognition_pcaa_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def note(what: str, phase: str = "setup") -> None:
    """A stage's end, in seconds since the process started, on standard
    error: a set-up stage, or a ``traced`` run's pass."""
    print(f"{phase} {what} {process_age_s():.3f}", file=sys.stderr, flush=True)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest() -> Dict:
    """``BENCHMARK.json`` of this checkout."""
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Context:
    """What a cell module gets: the cell's entry, its configuration file, its
    mix, its limits, the seed, the device and the run's options."""

    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    device: str
    end_to_end: List[Dict]
    per_layer: List[Dict]
    # a fault planted in the timed path, which the comparison must catch
    # ("half_batch", "altered"; ``benchmark/calibrate.py`` and the tests)
    fault: Optional[str] = None

    @property
    def dims(self) -> Dict:
        return self.config["overrides"]

    @property
    def n_classes(self) -> int:
        return len(self.dims["TRAIN_CLASSES"])


def load_context(workload: str, seed: int, device: str, manifest: Optional[Dict] = None,
                 dims: Optional[Dict] = None, **hooks) -> Context:
    """The cell's context from ``BENCHMARK.json`` and the cell's files;
    ``dims`` replaces configuration values (the CPU tests' small sizes)."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = _json(os.path.join(ROOT, config["file"]))
    if dims:
        config = dict(config, overrides={**config["overrides"], **dims})
    traffic = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", workload + ".json"))

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Context(cell, config, traffic, limits, seed, device, mine(manifest["end_to_end"]),
                   mine(manifest["per_layer"]), **hooks)


def cell_module(ctx: Context):
    return importlib.import_module(
        f"benchmark.cells.{ctx.traffic['mode']}_{ctx.config['family']}")


def metric_reader(name: str) -> Callable:
    """``read(trace)`` of ``benchmark/metrics/<name>.py`` (loaded by path: a
    metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device: str) -> Dict:
    import torch

    if device == "cpu":  # the CPU tests only; never a result of the benchmark
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak_bytes(device)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def peak_bytes(device: str) -> int:
    """The device's peak of allocated memory over the process so far."""
    import torch

    return 0 if device == "cpu" else int(torch.cuda.max_memory_allocated())


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx: Context, seconds: float, trace: bool, started: float) -> Tuple[Dict, List]:
    """One run → (the result object, the compared numbers ``[(name,
    value, limit)]``). ``started``: the process's start on the
    ``time.perf_counter`` clock."""
    from benchmark import program, tracing

    drv = cell_module(ctx)
    cell = drv.Cell(ctx)
    sync(ctx.device)
    setup_s = time.perf_counter() - started
    breakdown = None
    if not trace:
        t0 = time.perf_counter()
        work = cell.window(t0 + seconds)
        sync(ctx.device)
        elapsed = time.perf_counter() - t0
        metrics = {"setup_s": setup_s, "peak_mem_gb": peak_bytes(ctx.device) / 1e9,
                   **cell.end_to_end(work, elapsed)}
        units = {m["name"]: m["unit"] for m in ctx.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units}
        extra = {}
    else:
        # a steady part: the first half of the window untraced, then the segment
        cell.window(time.perf_counter() + seconds / 2)
        note("untraced", "traced")
        tr, with_host = tracing.traced(cell.segment, cell.counted, cell.info())
        note("device_and_host", "traced")
        # a third pass, inside the program's recorder: its spans and counters,
        # which the span metrics read; the device times stay the first pass's
        tr.program = program.traced_program(cell.segment, cell.counted, cell.info())
        note("program", "traced")
        metrics = {}
        for m in ctx.per_layer:
            value = metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tracing.busy_s(tr), "window_s": tr.window_s}
        breakdown = {"device_ops": tracing.top_ops(tr), "idle_gaps": tracing.idle_gaps(with_host)}
    device = {**device_info(ctx.device), **extra}
    attempted, failed = cell.attempted()
    readings = cell.readings()
    cell.free()
    del cell
    free_device()
    compared = drv.check(ctx, readings)
    if trace:
        note("reference", "traced")
    correct = bool(compared) and all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    return result, compared
