"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and every file and module a cell needs."""

import importlib
import json
import os
import re

import pytest

from benchmark import flops, harness, tracing
from benchmark.tests.conftest import tiny_context

ROOT = harness.ROOT
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
WIDTH = re.compile(r"(_dim|_rank|DIM|SIZE|FILTERS|hidden|intermediate|latent|head)", re.I)


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(MANIFEST["command"]) <= 32
    for word in MANIFEST["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_full_check_fits():
    """A full check of 24 cells at this run length fits in 43200 s."""
    n = 24
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * n) * (rs + 60) + n * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_plain(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in MANIFEST["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= set(CELLS)
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", metric["name"] + ".py"))


def test_setup_bound():
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    ctx = harness.load_context(cell["name"], 1, "cpu", manifest=MANIFEST)
    importlib.import_module(f"benchmark.cells.{ctx.traffic['mode']}_{ctx.config['family']}")
    e2e = [m["name"] for m in ctx.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and ctx.per_layer
    assert set(ctx.limits) >= {"loss_gap"} or set(ctx.limits) >= {"logit_gap"}


def test_cells_unique_pairs_and_configs_used():
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in MANIFEST["configs"]} == {c["config"] for c in MANIFEST["workloads"]}


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/")
    body = json.load(open(os.path.join(ROOT, config["file"])))
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    for key in ("source", "why"):
        assert 1 <= len(config[key]) <= 200 and "\n" not in config[key] and "\t" not in config[key]


# what each MFU metric asks of a family's FLOP count
FLOP_COUNTS = {"train_mfu": "step_flops", "eval_mfu": "crop_flops"}


@pytest.mark.parametrize("metric,cell", [(m["name"], c) for m in MANIFEST["per_layer"]
                                         if m["name"] in FLOP_COUNTS
                                         for c in m.get("workloads", CELLS)])
def test_mfu_cells_have_their_familys_flops(metric, cell):
    ctx = harness.load_context(cell, 1, "cpu", manifest=MANIFEST)
    family = ctx.config["family"]
    assert os.path.isfile(os.path.join(flops.HERE, family + ".py")), family
    assert callable(getattr(flops.family(family), FLOP_COUNTS[metric], None)), family


@pytest.mark.parametrize("cell", CELLS)
def test_counted_parts_have_kernel_files(cell):
    """Every key of the cell's launch counters is a part with a
    ``benchmark/kernels/<part>.json``."""
    ctx = tiny_context(cell, 1)
    built = harness.cell_module(ctx).Cell(ctx)
    parts = built.counted()
    built.free()
    assert parts
    for part in parts:
        assert os.path.isfile(os.path.join(tracing.KERNELS, part + ".json")), part
        assert tracing.fragments(part) == tracing.PORT_KERNELS[part]
