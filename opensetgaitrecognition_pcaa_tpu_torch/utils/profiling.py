"""Profiling utilities: device traces and a throughput counter.

Port of ``opensetgaitrecognition_pcaa_tpu/utils/profiling.py``. ``trace``
records what ``jax.profiler`` records there, with ``torch.profiler``: the
host's operators and, on a CUDA machine, the kernels on the card, written
as a Chrome trace (``trace.json``, which Perfetto and chrome://tracing
read) into ``log_dir``. ``StepTimer`` counts items per second and ends
each timed span by copying one tensor of the result to the host, which
waits for the work that made it, as the JAX timer does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``<log_dir>/trace.json``; yields the profiler,
    whose ``key_averages()`` tables the same events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def first_tensor(result: Any) -> Optional[torch.Tensor]:
    """The first tensor of a result: itself, or the first found in its
    dicts, lists and tuples in order; None if it holds none."""
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            t = first_tensor(item)
            if t is not None:
                return t
    return None


class StepTimer:
    """Throughput counter with explicit completion forcing: time through
    ``stop(result)``, which copies one tensor of ``result`` to the host, so
    that a span ends when the card has made it and not when the host has
    queued the launches."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self.total_seconds = 0.0
        self.total_items = 0

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, result, n_items: int) -> float:
        leaf = first_tensor(result)
        if leaf is not None:
            leaf.detach().cpu()  # waits for the work that made it
        dt = time.time() - self._t0
        self.total_seconds += dt
        self.total_items += n_items
        return dt

    @property
    def items_per_sec(self) -> float:
        return self.total_items / max(self.total_seconds, 1e-9)

    def summary(self) -> Dict[str, float]:
        return {
            "total_seconds": self.total_seconds,
            "total_items": float(self.total_items),
            "items_per_sec": self.items_per_sec,
        }
