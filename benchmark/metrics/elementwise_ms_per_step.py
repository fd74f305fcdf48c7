"""Device ms a training step of PyTorch's own elementwise, reduction, index
and copy kernels: every kernel that is neither one of the program's
hand-written kernels, nor a cuBLAS GEMM or cuDNN convolution, nor a memcpy
or memset (``tracing.kind``)."""

from benchmark import tracing


def read(trace):
    return tracing.device_ms(trace, lambda n: tracing.kind(n) == "elementwise") / trace.work["steps"]
