"""The device's idle share of the traced training segment, in %: the time
in which no operation ran on the device (the union of kernel and copy
intervals) over the segment's host-clock length."""

from benchmark import tracing


def read(trace):
    return 100.0 * (1.0 - tracing.busy_s(trace) / trace.window_s)
