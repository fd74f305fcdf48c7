"""Profiling utilities: the program's spans and counters, and device traces.

``span(name)`` marks a phase of the program and ``count(name, n)`` counts
its work. Both cost nothing while no ``recording()`` block is open: ``span``
returns one shared no-op context and ``count`` returns at once. Inside
``recording()`` a process-wide ``Recorder`` keeps the spans (name, parent,
start and end on ``time.time_ns()``, the clock torch.profiler stamps its
events on), the counters by name and, on a CUDA machine, the host syncs
(``torch.cuda.set_sync_debug_mode``'s warnings) charged to the innermost
open span; each span also enters a ``record_function`` of its name (the
fast form torch.compile's code uses, a tenth of the Python form's cost), so
a profiler's trace of the block shows the program's phases.

``trace`` records what ``jax.profiler`` records in
``opensetgaitrecognition_pcaa_tpu/utils/profiling.py``, with
``torch.profiler``: the host's operators, the program's spans and, on a
CUDA machine, the kernels on the card, written as a Chrome trace
(``trace.json``, which Perfetto and chrome://tracing read) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch

# the message of torch.cuda.set_sync_debug_mode("warn")'s warnings
SYNC_WARNING = "called a synchronizing CUDA operation"

_OFF = contextlib.nullcontext()


class Recorder:
    """What a ``recording()`` block holds: ``spans`` as ``[name, parent,
    start_ns, end_ns]`` in the order they opened (``parent`` the index of
    the enclosing span, -1 for none; ``end_ns`` 0 while open), ``counters``
    by name, and ``syncs``: host syncs by the index of the innermost span
    open when they happened (-1: outside every span)."""

    def __init__(self) -> None:
        self.spans: List[list] = []
        self.counters: Dict[str, int] = {}
        self.syncs: Dict[int, int] = {}
        self._open: List[int] = []
        # the list warnings.catch_warnings(record=True) fills (CUDA only),
        # and the warnings other than syncs, shown again when the block ends
        self._caught: Optional[list] = None
        self._other: list = []

    def _charge(self) -> None:
        """Charge the syncs warned since the last call to the innermost
        open span."""
        if not self._caught:
            return
        n = 0
        for w in self._caught:
            if SYNC_WARNING in str(w.message):
                n += 1
            else:
                self._other.append(w)
        self._caught.clear()
        if n:
            key = self._open[-1] if self._open else -1
            self.syncs[key] = self.syncs.get(key, 0) + n


class _Span:
    __slots__ = ("rec", "name", "index", "mirror")

    def __init__(self, rec: Recorder, name: str) -> None:
        self.rec, self.name = rec, name

    # the stamps lie inside the mirror's, next to them
    def __enter__(self) -> None:
        rec = self.rec
        rec._charge()
        self.mirror = torch._C._profiler._RecordFunctionFast(self.name)
        self.mirror.__enter__()
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec._open[-1] if rec._open else -1, time.time_ns(), 0])
        rec._open.append(self.index)

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec._charge()
        rec.spans[self.index][3] = time.time_ns()
        rec._open.pop()
        self.mirror.__exit__(*exc)


_recorder: Optional[Recorder] = None


def span(name: str):
    """A context that records the block as the span ``name`` while a
    ``recording()`` block is open; else one shared no-op context."""
    rec = _recorder
    return _OFF if rec is None else _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``recording()`` block is
    open."""
    rec = _recorder
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Turn the process-wide recorder on for the block and yield it; on a
    CUDA machine, count host syncs through ``set_sync_debug_mode("warn")``.
    Both are restored when the block ends, by an exception too."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording() block is open already")
    rec = Recorder()
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            rec._caught = stack.enter_context(warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            stack.callback(torch.cuda.set_sync_debug_mode, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")
        _recorder = rec
        try:
            yield rec
        finally:
            rec._charge()
            _recorder = None
    for w in rec._other:
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and the program's recorder, and write
    ``<log_dir>/trace.json``; yields the profiler, whose ``key_averages()``
    tables the same events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, recording():
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
