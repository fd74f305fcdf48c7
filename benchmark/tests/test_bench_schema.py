"""One run of each cell on the CPU at small widths: the result line's keys,
types and order, the traced run's device times and breakdown, and the
per-layer metrics each cell lists."""

import json
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_context

CELLS = [w["name"] for w in json.load(open(harness.ROOT + "/BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    ctx = tiny_context(workload, 2**32 + 9)
    result, compared = harness.run(ctx, 0.5, bool(trace), time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(ctx.limits) == {name for name, _, _ in compared}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    names = {m["name"] for m in (ctx.per_layer if trace else ctx.end_to_end)}
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert result["device"]["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    else:
        assert names == set(result["metrics"])
    json.dumps(result)
