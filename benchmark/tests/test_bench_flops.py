"""The per-layer metrics' operation and byte counts against hand
arithmetic at the published widths (PointNet 4→512→512→1024→1024, TCN
16..512, latent 32, decoder 1125..18000, 30 frames of 150 points, 6
classes, B = 16; eval chunks of 256 crops)."""

import importlib.util
import json
import os

import pytest

from benchmark import harness, tracing

DIMS = json.load(open(os.path.join(harness.HERE, "configs", "pcaa_v4.json")))["overrides"]


def metric(name):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_v4_step_flops():
    # PointNet: 72,000 rows x (4·512 + 512·512 + 512·1024 + 1024·1024) x 2 =
    # 264,536,064,000 forward; x 3, less layer 1's input gradient (294,912,000)
    pointnet = 3 * 264_536_064_000 - 294_912_000
    tcn = 3 * 550_010_880          # 480 rows x 3 x 190,976 x 2
    heads = 3 * 543_744            # 16 x (512·32 + 32·16 + 16·6) x 2
    decoder = 3 * 6_887_369_536    # 16 x (32·64 + 64·1125 + ... + 9000·18000) x 2
    critic = 14 * 144_384          # 16 x (38·64 + 64·32 + 32) x 2, 14 times
    dph = 98_304                   # 16 x 32·32 x 2, 3 times
    want = pointnet + tcn + heads + decoder + critic + dph
    assert want == 815_629_172_160
    assert metric("train_mfu").step_flops(DIMS, 16, "pcaa", 6) == want


def test_orced_step_flops():
    pointnet = 3 * 264_536_064_000 - 294_912_000
    tcn = 3 * 550_010_880
    heads = 3 * 1_054_720          # 16 x (512·32 + 512·32 + 32·6) x 2
    decoder = 3 * 6_886_152_000    # 16 x (32·1125 + ... + 9000·18000) x 2
    mean_learner = 3 * 150_528 - 3_072
    assert metric("train_mfu").step_flops(DIMS, 16, "orced", 6) == (
        pointnet + tcn + heads + decoder + mean_learner) == 815_625_381_312


def test_pointnet_train_bounds():
    bounds = metric("pointnet_train_roofline").layer_bounds(DIMS, 16)
    assert len(bounds) == 5
    # layer 1: 148,622,368 bytes at 3.35 TB/s (its 0.29 GFLOP take 0.6 µs)
    assert bounds[0] == pytest.approx(148_622_368 / 3.35e12)
    # layer 4: 150,994,944,000 operations at 495 TFLOP/s (594 MB take 177 µs)
    assert bounds[3] == pytest.approx(150_994_944_000 / 495e12)
    # the pool: 72,000 x 1024 floats read, 480 x 1024 written, the affine
    assert bounds[4] == pytest.approx(4 * (73_728_000 + 2048 + 491_520) / 3.35e12)
    # layer 2 bytes (295,970,816), layer 3 operations (75,497,472,000)
    assert bounds[1] == pytest.approx(295_970_816 / 3.35e12)
    assert bounds[2] == pytest.approx(75_497_472_000 / 495e12)
    assert sum(bounds) == pytest.approx(6.789e-4, rel=1e-3)


def test_adam_bound():
    m = metric("adam_roofline")
    # the decoder leaves of at least 2^21 elements: 1125·2250 .. 9000·18000
    assert m.kernel_elements(DIMS) == 2_531_250 + 10_125_000 + 40_500_000 + 162_000_000
    assert tracing.bound(12 * 215_156_250, 28 * 215_156_250, "f32") == pytest.approx(1.79831e-3,
                                                                                     rel=1e-5)


def test_eval_flops_and_infer_bound():
    assert metric("eval_mfu").crop_flops(DIMS, 6) == 16_567_913_664
    # a chunk of 256 crops: 1,152,000 points x 1,837,056 x 2 = 4.2326 TFLOP
    assert metric("pointnet_infer_roofline.eval").launch_bound(DIMS, 256) == pytest.approx(
        4_232_577_024_000 / 495e12)


def _trace(kernels):
    return tracing.Trace(kernels=kernels, window_s=1.0, work={"steps": 1}, cell={},
                         host=[("bench.segment", 0.0, 1e6), ("aten::mm", 100.0, 400.0)],
                         window=(0.0, 1e6))


def test_idle_union_and_gaps():
    tr = _trace([("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 400.0, 1e6)])
    assert tracing.busy_s(tr) == pytest.approx((150 + 1e6 - 400) / 1e6)
    gaps = tracing.idle_gaps(tr)
    assert gaps == [["bench.segment/aten::mm", pytest.approx(250e-6)]]
    assert metric("device_idle_share.train").read(tr) == pytest.approx(100 * 250 / 1e6)


def test_kinds():
    assert tracing.kind("void tf32x3::kernel<Epi>(...)") == "port"
    assert tracing.kind("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n") == "gemm"
    assert tracing.kind("void cudnn::engines_precompiled::fprop(...)") == "gemm"
    assert tracing.kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert tracing.kind("void at::native::vectorized_elementwise_kernel<4>(...)") == "elementwise"
