"""The pass with the program's recorder on (``benchmark/program.py``): on
the CPU at small widths, its spans against the segment's work and window,
its metrics in each cell, a cell's whole run with it; and its arithmetic on
a made-up trace with kernels, launches and syncs, which a CPU run has
none of."""

import json
import math
import time

import pytest

from benchmark import harness, program
from benchmark.tests.conftest import tiny_context

MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
# each metric that reads the pass, with each cell its entry lists
LISTED = [(m["name"], cell) for m in MANIFEST["per_layer"] if m["name"] in program.METRICS
          for cell in m.get("workloads", CELLS)]
SEED = 2**32 + 21
_cells = {}


def traced(workload):
    """The cell built once at small widths, and one pass of its segment."""
    if workload not in _cells:
        ctx = tiny_context(workload, SEED)
        cell = harness.cell_module(ctx).Cell(ctx)
        tr = program.traced_program(cell.segment, cell.counted, cell.info())
        cell.free()
        _cells[workload] = tr
    return _cells[workload]


@pytest.mark.parametrize("workload", ["pcaa_v4.train_b16", "orced.train_b16"])
def test_a_train_segment_records_its_steps_inside_the_window(workload):
    pt = traced(workload)
    lo, hi = pt.window
    assert hi > lo
    assert sum(1 for s in pt.spans if s[0] == "train.step") == pt.work["steps"]
    assert pt.counters["train.steps"] == pt.work["steps"]
    for name, parent, a, b in pt.spans:
        assert lo <= a <= b <= hi, name
        assert parent < 0 or pt.spans[parent][2] <= a <= b <= pt.spans[parent][3]


def test_an_eval_segment_records_its_chunks():
    pt = traced("pcaa_v4.eval_b256")
    chunks = pt.counters["eval.chunks"]
    assert chunks >= 1
    assert sum(1 for s in pt.spans if s[0] == "eval.h2d") == chunks
    assert all(pt.window[0] <= a <= b <= pt.window[1] for _, _, a, b in pt.spans)


def test_the_pass_has_its_metrics():
    assert {"step_idle_ms.train": "ms", "epoch_idle_ms.train": "ms/epoch",
            "host_syncs_per_step.train": "syncs/step",
            "h2d_idle_ms_per_chunk.eval": "ms"}.items() <= program.METRICS.items()


@pytest.mark.parametrize("metric,workload", LISTED)
def test_each_metric_reads_a_number_where_its_spans_are(metric, workload):
    """A number in every cell that the metric's entry lists; None from a
    trace with no program pass."""
    class First:  # the first pass's trace, which the harness hands the readers
        program = traced(workload)

    value = harness.metric_reader(metric)(First())
    assert isinstance(value, float) and math.isfinite(value) and value >= 0
    assert harness.metric_reader(metric)(object()) is None


def test_the_harness_reports_the_span_metrics():
    """A traced run of the harness takes the pass: a training cell's line
    holds the three span metrics of the train step."""
    ctx = tiny_context("pcaa_v4.train_b16", SEED)
    result, _ = harness.run(ctx, 0.3, True, time.perf_counter())
    assert result["correct"] is True
    for name in ("step_idle_ms.train", "epoch_idle_ms.train", "host_syncs_per_step.train"):
        m = result["metrics"][name]
        assert m["unit"] == program.METRICS[name] and math.isfinite(m["value"]), name
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cells_run_with_the_pass():
    ctx = tiny_context("orced.train_b16", SEED)
    line = program.run(ctx, 0.3)
    json.dumps(line)
    assert {n for n, cell in LISTED if cell == "orced.train_b16"} <= set(line["metrics"])
    for m in line["metrics"].values():
        assert isinstance(m["value"], float)
    assert line["metrics"]["host_syncs_per_step.train"]["value"] == 0.0  # no card: no syncs
    for key in ("idle_by_span", "syncs_by_span"):
        assert len(line["breakdown"][key]) <= 10
    assert "device_ms_by_span" not in line["breakdown"]  # no kernel, no launch
    p = line["program_pass"]
    steps = p["counters"]["train.steps"]
    closes = (line["metrics"]["step_idle_ms.train"]["value"] * steps
              + line["metrics"]["epoch_idle_ms.train"]["value"])
    assert closes == pytest.approx(p["idle_ms"], rel=1e-9)


def made_up():
    """A window 0-100 µs; an epoch 0-100 holding two steps (10-40, 50-80),
    each with an encoder span (12-30, 52-70); kernels at 15-25 and 55-60
    launched inside the encoders, 32-38 launched inside the first step,
    and a copy at 85-90 with no launch event; syncs in the first encoder
    and outside every span."""
    spans = [("train.epoch", -1, 0.0, 100.0), ("train.step", 0, 10.0, 40.0),
             ("train.encoder", 1, 12.0, 30.0), ("train.step", 0, 50.0, 80.0),
             ("train.encoder", 3, 52.0, 70.0)]
    kernels = [("k", 15.0, 25.0), ("k", 32.0, 38.0), ("k", 55.0, 60.0), ("memcpy", 85.0, 90.0)]
    return program.ProgramTrace(kernels=kernels, window_s=1e-4, work={"steps": 2}, cell={},
                                window=(0.0, 100.0), spans=spans, counters={"train.steps": 2},
                                syncs={2: 3, -1: 1}, launched=[13.0, 31.0, 53.0, None])


def test_the_arithmetic_on_a_made_up_trace():
    pt = made_up()
    assert program.idle(pt) == [(0.0, 15.0), (25.0, 32.0), (38.0, 55.0), (60.0, 85.0),
                                (90.0, 100.0)]
    # idle inside the steps: 10-15, 25-32, 38-40 and 50-55, 60-80
    assert program.idle_ms(pt, "train.step") == pytest.approx(0.039)
    assert program.idle_outside_ms(pt, "train.step") == pytest.approx(0.074 - 0.039)
    assert program.syncs_under(pt, "train.step") == 3
    assert program.syncs_by_span(pt) == [["train.encoder", 3], ["none", 1]]
    assert program.innermost(pt) == [
        (0.0, 10.0, 0), (10.0, 12.0, 1), (12.0, 30.0, 2), (30.0, 40.0, 1), (40.0, 50.0, 0),
        (50.0, 52.0, 3), (52.0, 70.0, 4), (70.0, 80.0, 3), (80.0, 100.0, 0)]
    by_idle = dict(map(tuple, program.idle_by_span(pt)))
    assert by_idle == pytest.approx({"train.epoch": 0.035, "train.encoder": 0.021,
                                     "train.step": 0.018})
    by_launch = dict(map(tuple, program.device_ms_by_span(pt)))
    assert by_launch == pytest.approx({"train.encoder": 0.015, "train.step": 0.006})
    first = type("First", (), {"program": pt})()
    assert harness.metric_reader("step_idle_ms.train")(first) == pytest.approx(0.0195)
    assert harness.metric_reader("epoch_idle_ms.train")(first) == pytest.approx(0.035)
    assert harness.metric_reader("host_syncs_per_step.train")(first) == 1.5
