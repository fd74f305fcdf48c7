"""Device ms a training step of cuBLAS GEMMs and cuDNN convolutions
(``tracing.kind``); None where the segment ran none."""

from benchmark import tracing


def read(trace):
    ms = tracing.device_ms(trace, lambda n: tracing.kind(n) == "gemm")
    return ms / trace.work["steps"] if ms > 0 else None
