"""The DGCNN configuration's benchmark files: the reference's leaves against
the program's parameters at the published widths, the FLOP count and the
kernels' bounds against hand arithmetic, the plain reference against the
program's CPU path at small sizes (``graph_gap`` 0), and the planted faults
caught: half of each batch left out, and one point's k-th neighbour swapped
for its (k+1)-th."""

import dataclasses
import json
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.flops import pcaa_dgcnn
from benchmark.reference import pcaa_v4_dgcnn as ref
from benchmark.tests.conftest import TINY, TINY_MIX

CELL = "pcaa_v4_dgcnn.train_b16"
DIMS = json.load(open(os.path.join(harness.HERE, "configs", "pcaa_v4_dgcnn.json")))["overrides"]
SMALL = dict(TINY, DGCNN_K=5, DGCNN_WIDTHS=[8, 8, 16, 16], DGCNN_EMB_DIMS=32)


def small_context(seed, **hooks):
    torch.set_num_threads(2)
    ctx = harness.load_context(CELL, seed, "cpu", dims=SMALL, **hooks)
    ctx.traffic = dict(ctx.traffic, **TINY_MIX, batch=8)
    return ctx


def test_leaves_are_the_programs_parameters():
    """At the published widths, on the meta device: every name and shape."""
    from benchmark.cells.train_pcaa_dgcnn import config, spec
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, PCAAModules

    ctx = harness.load_context(CELL, 1, "cpu")
    variant = dataclasses.replace(VARIANTS[VARIATION.V4], use_disc_head=True)
    with torch.device("meta"):
        mods = PCAAModules(config(ctx), variant, torch.Generator(), spec(ctx))
    own = {k: tuple(p.shape) for m in (mods.g, mods.d) for k, p in m.named_parameters()}
    want = {name: shape for name, shape, _ in ref.leaves(DIMS, 6)}
    assert own == want
    edges = 64 * 8 + 64 * 128 + 128 * 128 + 256 * 256 + 2 * 512
    conv5 = 1024 * 512 + 2 * 1024
    tcn = sum(3 * a * b + 3 * b for a, b in zip((2048, 16, 32, 64, 128, 256),
                                                 (16, 32, 64, 128, 256, 512)))
    heads = 512 * 32 + 32 + 32 * 16 + 16 + 16 * 6 + 6
    encoder = sum(torch.Size(s).numel() for k, s in want.items() if k.startswith("encoder."))
    assert encoder == edges + conv5 + tcn + heads == 1_260_134


def test_step_flops_by_hand():
    rows = 16 * 30 * 150  # 72,000 points a step
    products = 2 * rows * (4 * 128 + 64 * 128 + 64 * 256 + 128 * 512)  # 13.05 GFLOP forward
    assert products == 13_049_856_000
    first_input_grad = 2 * rows * 4 * 128
    conv5 = 3 * 2 * rows * 512 * 1024
    tcn = 3 * 2 * 480 * 3 * (2048 * 16 + 16 * 32 + 32 * 64 + 64 * 128 + 128 * 256 + 256 * 512)
    assert pcaa_dgcnn.encoder_flops(DIMS, 16) == 3 * products - first_input_grad + conv5 + tcn
    heads = 3 * 2 * 16 * (512 * 32 + 32 * 16 + 16 * 6)
    decoder = 3 * 6_887_369_536  # as V4's
    critic, dph = 14 * 144_384, 98_304
    assert pcaa_dgcnn.step_flops(DIMS, 16, 6) == (pcaa_dgcnn.encoder_flops(DIMS, 16) + heads
                                                  + decoder + critic + dph)
    assert 288e9 < pcaa_dgcnn.step_flops(DIMS, 16, 6) < 288.1e9


def test_kernel_bounds_by_hand():
    from benchmark.tests.test_bench_flops import metric

    # the graphs, each layer bound by its operations at 67 TFLOP/s: 480 frames
    # x (3 x 11,325 unordered pairs x (4 + 64 + 64 + 128) channels + 4 layers
    # x 20 rounds of a minimum over 150 x 150); layer 1's bytes (4 channels in,
    # 20 indices out a point) at 3.35 TB/s would take less
    knn = metric("dgcnn_knn_roofline")
    assert knn.step_bound(DIMS, 16) == pytest.approx(
        480 * (3 * 11_325 * 260 + 4 * 20 * 22_500) / 67e12)
    assert 72_000 * (4 * 4 + 8 * 20) / 3.35e12 < 480 * knn.frame_ops(150, 4, 20) / 67e12
    # the edge passes: bytes at 3.35 TB/s over widths 64 + 64 + 128 + 256
    fwd, bwd = metric("dgcnn_edge_roofline").step_bounds(DIMS, 16)
    points, edges = 72_000, 1_440_000
    assert fwd == pytest.approx((4 * points * 512 * 3 + 4 * 8 * edges) / 3.35e12)
    assert bwd == pytest.approx((4 * points * 512 * 5 + 4 * 8 * edges) / 3.35e12)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_matches_program(seed):
    nums = calibrate.readings(small_context(seed), "program", {})
    nums.pop("leaves", None)
    assert nums["graph_gap"] == 0.0, nums
    assert all(v < 1e-4 for v in nums.values()), nums


def test_half_batch_left_out():
    result, _ = harness.run(small_context(2**31 + 11, fault="half_batch"), 0.3, False,
                            time.perf_counter())
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert {"loss_gap", "graph_gap"} <= failed, result["checks"]


def test_graph_fault_fails_graph_gap():
    """One swapped neighbour of one point of layer 1, each step: the other
    numbers hold (the reference runs on the program's graphs), ``graph_gap``
    does not."""
    ctx = small_context(2**31 + 13, fault="graph")
    nums = calibrate.readings(ctx, "graph", {})
    assert nums["graph_gap"] > ctx.limits["graph_gap"], nums
    assert nums["loss1_gap"] <= ctx.limits["loss1_gap"], nums


@pytest.mark.gpu
def test_control_fails_on_the_card(cuda):
    """The reference in TF32 in the program's place fails at least one
    limit at the cell's own size, and not every one."""
    ctx = harness.load_context(CELL, 2**31 + 11, cuda)
    cache = {}
    calibrate.readings(ctx, "program", cache)
    nums = calibrate.readings(ctx, "control", cache)
    failed = [k for k, limit in ctx.limits.items() if nums[k] > limit]
    assert failed and len(failed) < len(ctx.limits), nums


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import benchmark.reference.pcaa_v4_dgcnn; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'opensetgaitrecognition_pcaa_tpu_torch', 'opensetgaitrecognition_pcaa_tpu', "
            "'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
