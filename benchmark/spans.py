"""Device time by the program's spans in which kernels were launched: the
``program_span`` metrics of one span, read from the pass with the program's
recorder on (``program.py``)."""

from __future__ import annotations

import bisect
from typing import Optional

from benchmark import program


def launched_in_ms(pt: program.ProgramTrace, name: str) -> Optional[float]:
    """Device ms of the kernels launched while a span ``name`` was open
    (those of the spans inside it too); None where the trace holds no such
    span, or kernels without a launch event; 0 where it holds no kernel."""
    spans = program.intervals(pt, name)
    if not spans or (pt.kernels and all(t is None for t in pt.launched)):
        return None
    starts = [a for a, _ in spans]
    total = 0.0
    for (_, a, b), t in zip(pt.kernels, pt.launched):
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            total += b - a
    return total / 1e3


def per_step_ms(trace, name: str) -> Optional[float]:
    """``launched_in_ms`` over the ``train.steps`` counter; None where the
    trace holds no step or no span ``name``."""
    pt = getattr(trace, "program", None)
    steps = pt.counters.get("train.steps", 0) if pt is not None else 0
    ms = launched_in_ms(pt, name) if steps else None
    return None if ms is None else ms / steps
