"""The port's ``utils/profiling.py`` and ``utils/debug.py`` on the CPU,
beside the JAX package's modules of the same names: ``trace`` writes a
Chrome trace that holds the traced operators; ``StepTimer`` counts items
per second with the JAX timer's summary keys, forcing completion through
one tensor of a result; ``enable_nan_checks`` turns autograd's anomaly
detection on and off, and with it on a NaN made by a backward raises."""

import json
import os

import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.utils.profiling import StepTimer as JaxStepTimer

from opensetgaitrecognition_pcaa_tpu_torch.utils.debug import enable_nan_checks
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import StepTimer, first_tensor, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        torch.mm(torch.randn(32, 32), torch.randn(32, 32))
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_step_timer_counts_items_per_second():
    timer = StepTimer()
    for n in (8, 16):
        timer.start()
        out = {"loss": torch.ones(()) * n, "extra": [torch.zeros(2)]}
        assert timer.stop(out, n) >= 0.0
    s = timer.summary()
    assert s.keys() == JaxStepTimer().summary().keys()
    assert s["total_items"] == 24.0 and s["total_seconds"] == timer.total_seconds > 0
    assert s["items_per_sec"] == pytest.approx(24.0 / timer.total_seconds)


def test_first_tensor_walks_the_result():
    t = torch.ones(1)
    assert first_tensor({"a": [None, (3, t)], "b": torch.zeros(1)}) is t
    assert first_tensor([1, "x"]) is None


def test_nan_checks_toggle_anomaly_detection():
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            # sqrt's backward at 0 divides the zero cotangent by 2 sqrt(0): 0 / 0
            (torch.sqrt(x) * 0).sum().backward()
        enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
