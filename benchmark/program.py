"""The program's own spans and counters in a traced segment, on the device
trace's clock, and the arithmetic of the metrics that read them.

The port's recorder (``utils/profiling.py``: ``recording``, ``span``,
``count``) stamps its spans with ``time.time_ns()``, the clock torch.profiler
stamps its events on; a span becomes the trace's µs as ``(ns −
trace_start_ns) / 1e3``. ``traced_program`` is a third traced pass beside
``tracing.traced``'s two: device activity only, taken again while it holds
fewer launches of a port kernel than the counters say, with the segment run
inside the recorder. ``harness.run`` takes it in every traced run and hands
it to the readers as ``trace.program``. Its readers are the per-layer
metrics whose ``source`` is ``program_span`` or ``program_counter``
(``METRICS``): ``benchmark/metrics/step_idle_ms.train.py`` and the like,
each of which returns None where the trace has none of its spans.

For the breakdown by span, run a cell with this pass's own line:

    python3 -m benchmark.program --workload <cell> --seed <n> --seconds <s>

from the root of a checkout: as ``benchmark.run --trace 1`` (half the
window untraced, then ``tracing.traced``), then this pass; it prints one
line with the cell's per-layer metrics, the first and the third pass's
window and busy time, and the breakdowns ``idle_by_span`` (device-idle ms
by the innermost program span), ``device_ms_by_span`` (device ms by the
span open at the kernel's launch) and ``syncs_by_span`` (host syncs by the
innermost span).
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import harness, tracing

SOURCES = ("program_span", "program_counter")
# the per-layer metrics that read this pass, by their ``source`` in
# BENCHMARK.json, and their units; their cells are their entries' ``workloads``
METRICS = {m["name"]: m["unit"] for m in harness.load_manifest()["per_layer"]
           if m["source"] in SOURCES}
NONE = "none"  # outside every span of the program


@dataclasses.dataclass
class ProgramTrace(tracing.Trace):
    """A traced segment run inside the program's recorder: ``spans`` as
    ``(name, parent index, start µs, end µs)`` on the kernels' clock,
    ``counters`` by name, ``syncs`` (host syncs by the index of the innermost
    span, -1 outside every span) and ``launched``: each kernel's launch in
    µs, None where the trace holds no launch event for it. ``window`` is the
    segment's own start and end, stamped on the spans' clock."""

    spans: List[Tuple[str, int, float, float]] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    syncs: Dict[int, int] = dataclasses.field(default_factory=dict)
    launched: List[Optional[float]] = dataclasses.field(default_factory=list)


def _profile(segment: Callable[[], Dict[str, float]], cell: Dict) -> ProgramTrace:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opensetgaitrecognition_pcaa_tpu_torch.utils import profiling

    cuda = torch.cuda.is_available()
    # (a CPU-only build, the tests': host activity alone, and no kernels)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            work = segment()
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            t1_ns = time.time_ns()
    results = prof.profiler.kineto_results
    start = results.trace_start_ns()

    def us(ns: int) -> float:
        return (ns - start) / 1e3

    window = (us(t0_ns), us(t1_ns))
    mirrors = {s[0] for s in rec.spans}
    kernels, corr, launches = [], [], {}
    for e in results.events():
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no operation of the device
            if e.name() not in mirrors and us(e.end_ns()) > window[0] \
                    and us(e.start_ns()) < window[1]:
                kernels.append((e.name(), us(e.start_ns()), us(e.end_ns())))
                corr.append(e.correlation_id())
        elif e.name().startswith("cu"):  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
            launches[e.correlation_id()] = us(e.start_ns())
    return ProgramTrace(
        kernels=kernels, window_s=seconds, work=work, cell=cell, window=window,
        spans=[(n, p, us(a), us(b)) for n, p, a, b in rec.spans], counters=dict(rec.counters),
        syncs=dict(rec.syncs), launched=[launches.get(c) for c in corr])


def traced_program(segment: Callable[[], Dict[str, float]], counted: Callable[[], Dict[str, int]],
                   cell: Dict) -> ProgramTrace:
    """``segment()`` traced with device activity alone inside the program's
    recorder, taken again while it holds fewer launches of a program kernel
    than ``counted()`` says, up to ``tracing.RETAKES`` times."""
    for attempt in range(1, tracing.RETAKES + 1):
        # the earlier passes' garbage (the host pass's event tree holds cycles)
        # collected now, and not by the interpreter inside the traced segment
        gc.collect()
        before = counted()
        pt = _profile(segment, cell)
        short = tracing.short_of(pt.kernels, before, counted())
        if not short:
            break
        print(f"program trace {attempt} of {tracing.RETAKES} holds fewer launches than the "
              f"counters of {short}: " + ("taken again" if attempt < tracing.RETAKES else "kept"),
              file=sys.stderr)
    return pt


# --- the arithmetic ----------------------------------------------------------------------------

def idle(pt: ProgramTrace) -> List[Tuple[float, float]]:
    """The gaps inside the window in which no operation ran on the device."""
    lo, hi = pt.window
    out, t = [], lo
    for a, b in tracing.union([(k[1], k[2]) for k in pt.kernels]):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float, object]]) -> Dict:
    """Of two sorted lists of disjoint intervals, ``ys`` with a label each:
    the µs that ``xs`` shares with each label's intervals."""
    out: Dict = {}
    i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out[ys[j][2]] = out.get(ys[j][2], 0.0) + b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def intervals(pt: ProgramTrace, name: str) -> List[Tuple[float, float]]:
    return tracing.union([(a, b) for n, _, a, b in pt.spans if n == name])


def idle_ms(pt: ProgramTrace, name: str) -> float:
    """Device-idle ms inside the spans ``name``."""
    return overlap(idle(pt), [(a, b, 0) for a, b in intervals(pt, name)]).get(0, 0.0) / 1e3


def idle_outside_ms(pt: ProgramTrace, name: str) -> float:
    """Device-idle ms in the window outside every span ``name``."""
    edges = [pt.window[0]] + [t for iv in intervals(pt, name) for t in iv] + [pt.window[1]]
    rest = [(edges[i], edges[i + 1], 0) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    return overlap(idle(pt), rest).get(0, 0.0) / 1e3


def syncs_under(pt: ProgramTrace, name: str) -> int:
    """Host syncs charged to a span ``name`` or to a span inside one."""
    def inside(i: int) -> bool:
        while i >= 0:
            if pt.spans[i][0] == name:
                return True
            i = pt.spans[i][1]
        return False

    return sum(n for i, n in pt.syncs.items() if inside(i))


def innermost(pt: ProgramTrace) -> List[Tuple[float, float, int]]:
    """The window cut where a span opens or closes, each piece with the
    index of the innermost span open over it (-1: none)."""
    edges = sorted([(a, 1, i) for i, (_, _, a, _) in enumerate(pt.spans)]
                   + [(b, 0, i) for i, (_, _, _, b) in enumerate(pt.spans)])
    pieces, stack, t = [], [], pt.window[0]
    for at, opens, i in edges:
        if at > t:
            pieces.append((t, at, stack[-1] if stack else -1))
            t = at
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if pt.window[1] > t:
        pieces.append((t, pt.window[1], -1))
    return pieces


def _top(by: Dict[str, float], n: int) -> List[List]:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _name(pt: ProgramTrace, i: int) -> str:
    return NONE if i < 0 else pt.spans[i][0]


def idle_by_span(pt: ProgramTrace, n: int = 10) -> List[List]:
    """Device-idle ms by the innermost program span open over it."""
    by: Dict[str, float] = {}
    for i, t in overlap(idle(pt), innermost(pt)).items():
        by[_name(pt, i)] = by.get(_name(pt, i), 0.0) + t / 1e3
    return _top(by, n)


def device_ms_by_span(pt: ProgramTrace, n: int = 10) -> Optional[List[List]]:
    """Device ms by the innermost program span open at each kernel's
    launch; None where the trace holds no launch event of a kernel."""
    pieces = innermost(pt)
    starts = [p[0] for p in pieces]
    by: Dict[str, float] = {}
    for (_, a, b), t in zip(pt.kernels, pt.launched):
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        name = _name(pt, pieces[k][2]) if 0 <= k and t < pieces[k][1] else NONE
        by[name] = by.get(name, 0.0) + (b - a) / 1e3
    return _top(by, n) if by else None


def syncs_by_span(pt: ProgramTrace) -> List[List]:
    by: Dict[str, int] = {}
    for i, k in pt.syncs.items():
        by[_name(pt, i)] = by.get(_name(pt, i), 0) + k
    return _top(by, len(by))


# --- a cell's run with the third pass ----------------------------------------------------------

def run(ctx: harness.Context, seconds: float) -> Dict:
    """The traced part of ``harness.run`` and then this pass → the line."""
    cell = harness.cell_module(ctx).Cell(ctx)
    cell.window(time.perf_counter() + seconds / 2)
    tr, _ = tracing.traced(cell.segment, cell.counted, cell.info())
    pt = traced_program(cell.segment, cell.counted, cell.info())
    tr.program = pt
    metrics = {}
    for m in ctx.per_layer:
        value = harness.metric_reader(m["name"])(tr)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    span_s = (pt.window[1] - pt.window[0]) / 1e6
    idle_s = sum(b - a for a, b in idle(pt)) / 1e6
    breakdown = {"idle_by_span": idle_by_span(pt), "syncs_by_span": syncs_by_span(pt)}
    by_launch = device_ms_by_span(pt)
    if by_launch is not None:
        breakdown["device_ms_by_span"] = by_launch
    cell.free()
    return {
        "metrics": metrics,
        "first_pass": {"window_s": tr.window_s, "busy_s": tracing.busy_s(tr),
                       "idle_share": 1.0 - tracing.busy_s(tr) / tr.window_s},
        "program_pass": {"window_s": pt.window_s, "span_s": span_s, "busy_s": span_s - idle_s,
                         "idle_ms": idle_s * 1e3, "idle_share": idle_s / span_s,
                         "counters": pt.counters,
                         "kernels": len(pt.kernels),
                         "launched": sum(t is not None for t in pt.launched)},
        "breakdown": breakdown,
        "device": harness.device_info(ctx.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(run(harness.load_context(args.workload, args.seed, "cuda"), args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
