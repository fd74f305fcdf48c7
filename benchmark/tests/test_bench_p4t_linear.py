"""The P4Transformer dense products' roofline (``metrics/
p4t_linear_roofline.py``): its count by hand at the published widths, and
the kernels' names read as the program's own."""

import json
import os

import pytest

from benchmark import harness, tracing
from benchmark.tests.test_bench_p4t import DIMS

ROOFLINE = harness.metric_reader("p4t_linear_roofline")
step_bound = ROOFLINE.__globals__["step_bound"]  # the reader's module, loaded by path
# the names a profiler gives the three products' kernels
NAMES = ("void tf32x3_wgmma::gemm_kernel<(anonymous namespace)::p4t_linear_out>(CUtensorMap, "
         "CUtensorMap, CUtensorMap, int, int, int, (anonymous namespace)::p4t_linear_out)",
         "(anonymous namespace)::p4t_linear_split_kernel(float const*, int, int, int, float*, "
         "float*)",
         "(anonymous namespace)::p4t_linear_wgrad_kernel(CUtensorMap, CUtensorMap, "
         "(anonymous namespace)::WgradArgs)",
         "(anonymous namespace)::p4t_linear_reduce_kernel(float*, float const*, int, long long, "
         "float const*, float*, int)")


def test_step_bound_by_hand():
    # 18,000 tokens, 5 blocks; a token's products 1024 x (3072 + 1024 + 2048) + 2048 x 1024
    flops = 3 * 2 * 18_000 * 5 * 1024 * (3 * 1024 + 1024 + 2 * 2048)
    assert flops == 4_529_848_320_000  # 4.53 TFLOP a step
    # every product is bound by its operations: at the one-pass TF32 peak, 9.15 ms
    assert step_bound(DIMS, 16) == pytest.approx(flops / 495e12, rel=1e-12)
    assert flops / 495e12 == pytest.approx(9.151e-3, abs=1e-6)


def test_the_kernels_are_the_programs_own():
    assert json.load(open(os.path.join(tracing.KERNELS, "p4t_linear.json"))) == ["p4t_linear"]
    for name in NAMES:
        assert tracing.kind(name) == "port"
        assert tracing.is_port_kernel(name, "p4t_linear")
    # cuBLAS's f32 GEMMs that the products replace stay GEMMs
    assert tracing.kind("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3") == "gemm"
    assert not tracing.is_port_kernel("cutlass_80_simt_sgemm_256x128_8x4_nn_align1",
                                      "p4t_linear")


def test_share_over_the_kernels_device_time():
    """Two steps' bound over the device time of the p4t_linear kernels
    alone; None where a segment ran none (the parent's)."""
    steps = 2
    bound_s = step_bound(DIMS, 16) * steps
    spent_us = 4 * bound_s * 1e6  # the kernels at a quarter of the one-pass bound
    kernels = [(NAMES[0], 0.0, spent_us / 2), (NAMES[2], 0.0, spent_us / 4),
               (NAMES[1], 0.0, spent_us / 8), (NAMES[3], 0.0, spent_us / 8),
               ("fmha_cutlassB_f32_aligned_128x64_k128_sm80", 0.0, 1e6)]
    cell = {"dims": DIMS, "batch": 16}
    trace = tracing.Trace(kernels=kernels, window_s=1.0, work={"steps": steps}, cell=cell)
    assert ROOFLINE(trace) == pytest.approx(25.0)
    assert ROOFLINE(tracing.Trace(kernels=kernels[4:], window_s=1.0, work={"steps": steps},
                                  cell=cell)) is None
