"""The P4Transformer configuration's benchmark files: the reference's
leaves against the program's parameters at the published widths, the FLOP
count and the tube's bounds against hand arithmetic, the plain reference
against the program's CPU path at small sizes, and a planted fault caught."""

import dataclasses
import json
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.flops import pcaa_p4t
from benchmark.reference import pcaa_v4_p4t as ref
from benchmark.tests.conftest import TINY, TINY_MIX

CELL = "pcaa_v4_p4t.train_b16"
DIMS = json.load(open(os.path.join(harness.HERE, "configs", "pcaa_v4_p4t.json")))["overrides"]
SMALL = dict(TINY, P4T_NSAMPLES=8, P4T_SPATIAL_STRIDE=4, P4T_DIM=64, P4T_DEPTH=2, P4T_HEADS=2,
             P4T_DIM_HEAD=32, P4T_MLP_DIM=128)


def small_context(seed, **hooks):
    torch.set_num_threads(2)
    ctx = harness.load_context(CELL, seed, "cpu", dims=SMALL, **hooks)
    ctx.traffic = dict(ctx.traffic, **TINY_MIX, batch=8)
    return ctx


def test_leaves_are_the_programs_parameters():
    """At the published widths, on the meta device: every name and shape."""
    from benchmark.cells.train_pcaa_p4t import config, spec
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, PCAAModules

    ctx = harness.load_context(CELL, 1, "cpu")
    variant = dataclasses.replace(VARIANTS[VARIATION.V4], use_disc_head=True)
    with torch.device("meta"):
        mods = PCAAModules(config(ctx), variant, torch.Generator(), spec(ctx))
    own = {k: tuple(p.shape) for m in (mods.g, mods.d) for k, p in m.named_parameters()}
    want = {name: shape for name, shape, _ in ref.leaves(DIMS, 6)}
    assert own == want
    encoder = sum(torch.Size(s).numel() for k, s in want.items() if k.startswith("encoder."))
    assert encoder == 5 * 8_396_800 + 2 * 5_120 + 2_048 + 32_800 + 528 + 102 == 42_029_718


def test_step_flops_by_hand():
    # 15 frames x 75 anchors = 1,125 tokens a crop, 18,000 a step of 16
    assert pcaa_p4t.sizes(DIMS, 16) == (1125, 18_000, 96)
    dense = 2 * 1024 * (3 * 1024 + 1024 + 2 * 2048)          # 16,777,216 a token and layer
    attention = 4 * 1125 * 1024                              # 4,608,000
    assert pcaa_p4t.transformer_flops(DIMS, 16) == 3 * 5 * 18_000 * (dense + attention) \
        == 5_774_008_320_000
    tube = 2 * 1_728_000 * 5 * 1024 + 2 * 18_000 * 5 * 1024  # forward + the weight gradient
    position = 2 * 2 * 18_000 * 4 * 1024
    heads = 3 * 2 * 16 * (1024 * 32 + 32 * 16 + 16 * 6)
    decoder = 3 * 6_887_369_536                               # as V4's
    critic, dph = 14 * 144_384, 98_304
    assert pcaa_p4t.step_flops(DIMS, 16, 6) == (5_774_008_320_000 + tube + position + heads
                                                + decoder + critic + dph)


def test_tube_bounds_by_hand():
    from benchmark.tests.test_bench_flops import metric

    fwd, bwd = metric("p4t_tube_roofline").step_bounds(DIMS, 16)
    # forward: 17,694,720,000 operations at 67 TFLOP/s (107 MB take 32 us)
    assert fwd == pytest.approx(2 * 1_728_000 * 5 * 1024 / 67e12)
    shared = 4 * 16 * 30 * 150 * 4 + 8 * (18_000 + 1_728_000) + 4 * 5 * 1024
    assert bwd == pytest.approx((shared + 5 * 18_000 * 1024) / 3.35e12)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_matches_program(seed):
    nums = calibrate.readings(small_context(seed), "program", {})
    nums.pop("leaves", None)
    assert nums and all(v < 1e-4 for v in nums.values()), nums


def test_half_batch_left_out():
    result, _ = harness.run(small_context(2**31 + 11, fault="half_batch"), 0.3, False,
                            time.perf_counter())
    assert result["correct"] is False


def test_span_device_time_on_a_made_up_trace():
    """Kernels launched inside ``train.encoder`` (at 13 and 53 µs: 10 and 5
    µs long) count; one launched in the step outside it and a copy with no
    launch event do not."""
    from benchmark import spans
    from benchmark.tests.test_bench_program import made_up

    pt = made_up()
    assert spans.launched_in_ms(pt, "train.encoder") == pytest.approx(0.015)
    assert spans.launched_in_ms(pt, "train.step") == pytest.approx(0.021)
    assert spans.launched_in_ms(pt, "p4t.embed") is None

    class First:
        program = pt

    assert spans.per_step_ms(First(), "train.encoder") == pytest.approx(0.0075)


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

    code = ("import sys; import benchmark.reference.pcaa_v4_p4t; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'opensetgaitrecognition_pcaa_tpu_torch', 'opensetgaitrecognition_pcaa_tpu', "
            "'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
