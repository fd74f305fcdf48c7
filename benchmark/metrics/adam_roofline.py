"""The Adam kernel's share of its roofline, in % (``csrc/adam.cu``, f32
moments): it updates the decoder's 2-D leaves of at least 2^21 elements,
each element reading its gradient, weight and two moments and writing
weight and moments, 28 bytes; about 12 f32 operations an element, at the
f32 (non-tensor) peak. Summed over the segment's steps, over the device
time of the kernel."""

from benchmark import tracing

MIN_KERNEL_ELEMS = 1 << 21


def kernel_elements(dims):
    """Elements of the decoder leaves that the kernel updates each step."""
    s = dims["NSTEPS"] * dims["NMAX"] * dims["NFEATURES"]
    widths = (2 * dims["SUP_LATENT_DIM"], s // 16, s // 8, s // 4, s // 2, s)
    sizes = [a * b for a, b in zip(widths[:-1], widths[1:])]
    return sum(n for n in sizes if n >= MIN_KERNEL_ELEMS)


def read(trace):
    n = kernel_elements(trace.cell["dims"])
    return tracing.roofline(trace, "adam", tracing.bound(12 * n, 28 * n, "f32")
                            * trace.work["steps"])
