"""The port's ``utils/profiling.py`` and ``utils/debug.py`` on the CPU:
``trace`` writes a Chrome trace that holds the traced operators (the
recorder's own tests are ``tests/test_torch_profiling.py``);
``enable_nan_checks`` turns autograd's anomaly detection on and off, and
with it on a NaN made by a backward raises."""

import json
import os

import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.utils.debug import enable_nan_checks
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import trace


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        torch.mm(torch.randn(32, 32), torch.randn(32, 32))
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


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
