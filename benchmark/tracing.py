"""The traced run: torch.profiler's events of a steady part of the window,
reduced to kernel intervals and host spans, and the arithmetic that the
per-layer metrics share (kernel kinds by name, busy time as the union of
kernel intervals, the chip's published peaks).

Kept from the port's smoke script (``_busy_ms``, ``traced_until_whole``):
kernels are told apart by name, and a trace that holds fewer launches of
the program's kernels than its launch counters say is taken again.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

# the program's own kernels by the part they belong to (a key of a cell's
# ``counted()``): ``benchmark/kernels/<part>.json``, its name fragments
KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def _parts() -> Dict[str, Tuple[str, ...]]:
    parts = {}
    for path in sorted(glob.glob(os.path.join(KERNELS, "*.json"))):
        with open(path) as f:
            parts[os.path.basename(path)[: -len(".json")]] = tuple(json.load(f))
    return parts


PORT_KERNELS = _parts()
_GEMM = ("gemm", "cutlass", "xmma", "cublas", "sgemm", "conv", "cudnn", "fprop", "dgrad",
         "wgrad", "implicit")
_COPY = ("memcpy", "memset")

RETAKES = 5


@dataclasses.dataclass
class Trace:
    """A traced segment: its kernel (and copy) intervals in µs on the
    profiler's clock, its length on the host's clock, the work it did and
    the cell it ran; ``host`` and ``window`` (the segment's span on the
    profiler's clock) where host spans were recorded too."""

    kernels: List[Tuple[str, float, float]]
    window_s: float
    work: Dict[str, float]
    cell: Dict
    host: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)


def fragments(part: str) -> Tuple[str, ...]:
    """The name fragments of ``part``'s kernels; an error that names the
    missing file where the part has none."""
    if part not in PORT_KERNELS:
        raise FileNotFoundError(f"no kernel part {part!r}: "
                                f"{os.path.join(KERNELS, part + '.json')} is missing")
    return PORT_KERNELS[part]


def is_port_kernel(name: str, part: str) -> bool:
    low = name.lower()
    return any(n in low for n in fragments(part))


def short_of(kernels: List[Tuple[str, float, float]], before: Dict[str, int],
             after: Dict[str, int]) -> List[str]:
    """The parts of which ``kernels`` holds fewer launches than their
    counters rose by from ``before`` to ``after``."""
    short = []
    for part in sorted(after):
        needles = fragments(part)
        launched = sum(1 for k in kernels if any(n in k[0].lower() for n in needles))
        if launched < after[part] - before[part]:
            short.append(part)
    return short


def kind(name: str) -> str:
    """"port" (a hand-written kernel of the program), "gemm" (cuBLAS and
    cuDNN), "copy" (memcpy, memset) or "elementwise" (every other kernel:
    PyTorch's elementwise, reduction, index and copy kernels)."""
    low = name.lower()
    if any(any(n in low for n in needles) for needles in PORT_KERNELS.values()):
        return "port"
    if any(n in low for n in _COPY):
        return "copy"
    if any(n in low for n in _GEMM):
        return "gemm"
    return "elementwise"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds in which at least one operation ran on the device."""
    return sum(b - a for a, b in union([(k[1], k[2]) for k in trace.kernels])) / 1e6


def device_ms(trace: Trace, keep: Callable[[str], bool]) -> float:
    return sum(b - a for n, a, b in trace.kernels if keep(n)) / 1e3


def roofline(trace: Trace, part: str, bound_s: float) -> Optional[float]:
    """``bound_s`` (the least time of the part's launches in the segment) as
    a share, in %, of the device time of the part's kernels; None where the
    segment ran none of them."""
    spent = device_ms(trace, lambda n: is_port_kernel(n, part)) / 1e3
    return None if spent <= 0 else 100.0 * bound_s / spent


def bound(flops: float, nbytes: float, precision: str) -> float:
    """The least time of work: the larger of its operations over the
    precision's peak and its bytes over the memory's."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def top_ops(trace: Trace, n: int = 10) -> List[List]:
    """The device operations that took most time, summed by name."""
    total: Dict[str, float] = {}
    for name, a, b in trace.kernels:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """The longest gaps between device operations inside the segment, each
    named by the innermost host span open at its start (the benchmark's
    span / PyTorch's op)."""
    busy = union([(k[1], k[2]) for k in trace.kernels])
    edges = [trace.window[0]] + [t for iv in busy for t in iv] + [trace.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        open_ = [h for h in trace.host if h[1] <= a < h[2]]
        bench = [h for h in open_ if h[0].startswith("bench.")]
        inner = min(open_, key=lambda h: h[2] - h[1])[0] if open_ else "none"
        outer = min(bench, key=lambda h: h[2] - h[1])[0] if bench else "none"
        out.append([f"{outer}/{inner}", (b - a) / 1e6])
    return out


def _events(prof) -> Tuple[List, List]:
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
            # a span's mirror on the device's timeline: no operation of the device
            if e.device_type == DeviceType.CPU:
                host.append(iv)
            continue
        if e.device_type == DeviceType.CUDA:
            kernels.append(iv)
        elif e.device_type == DeviceType.CPU:
            host.append(iv)
    return kernels, host


def _profile(segment: Callable[[], Dict[str, float]], host: bool):
    """``segment()`` under torch.profiler: device activity only, or with the
    host's ops and spans too → (work, seconds on the host's clock, kernels,
    host intervals, the segment's span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # (a CPU-only build, the tests': host activity alone)
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    acts += [ProfilerActivity.CPU] if host or not acts else []
    with profile(activities=acts) as prof:
        with record_function("bench.segment"):
            t0 = time.perf_counter()
            work = segment()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    kernels, spans = _events(prof)
    span = next((h for h in spans if h[0] == "bench.segment"), ("", 0.0, 0.0))
    if host:
        kernels = [k for k in kernels if k[2] > span[1] and k[1] < span[2]]
    return work, seconds, kernels, spans, (span[1], span[2])


def traced(segment: Callable[[], Dict[str, float]], counted: Callable[[], Dict[str, int]],
           cell: Dict) -> Tuple[Trace, Trace]:
    """Two traced runs of ``segment()`` (it returns the work it did): one
    that records device activity alone, whose times the metrics read
    (recording every host op slows an eager loop that the host bounds, and
    would inflate the idle share), taken again while it holds fewer
    launches of a program kernel than ``counted()`` (the program's launch
    counters, by part of ``PORT_KERNELS``) says, up to ``RETAKES`` times;
    and one with the host's ops and spans, which names the idle gaps."""
    for attempt in range(1, RETAKES + 1):
        before = counted()
        work, seconds, kernels, _, _ = _profile(segment, host=False)
        short = short_of(kernels, before, counted())
        if not short:
            break
        print(f"trace {attempt} of {RETAKES} holds fewer launches than the counters of {short}: "
              + ("taken again" if attempt < RETAKES else "kept"), file=sys.stderr)
    device = Trace(kernels=kernels, window_s=seconds, work=work, cell=cell)
    work, seconds, kernels, spans, window = _profile(segment, host=True)
    with_host = Trace(kernels=kernels, window_s=seconds, work=work, cell=cell, host=spans,
                      window=window)
    return device, with_host
