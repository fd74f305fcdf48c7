"""The comparison catches the faults a cell can have: a run whose timed
path is broken underneath comes out not correct. Each drives a whole run
(set-up, window, comparison) on the CPU at small widths, past the
harness's look for a card; the limits are the cells' own. The control,
the reference in TF32 in the program's place, needs the card: its test
runs there at the cell's own widths."""

import time

import pytest

from benchmark import calibrate, harness
from benchmark.tests.conftest import tiny_context

SEED = 2**31 + 11


def run(workload, **hooks):
    ctx = tiny_context(workload, SEED, **hooks)
    result, _ = harness.run(ctx, 0.3, False, time.perf_counter())
    return result


@pytest.mark.parametrize("workload", ["pcaa_v4.train_b16", "orced.train_b16"])
def test_half_batch_left_out(workload):
    assert run(workload, fault="half_batch")["correct"] is False


@pytest.mark.parametrize("workload", ["pcaa_v4.train_b16", "orced.train_b16"])
def test_state_left_unchanged(workload, monkeypatch):
    """Every Adam write of the program skipped: the step returns its
    parameters unchanged."""
    from opensetgaitrecognition_pcaa_tpu_torch.train import orced, pcaa

    def no_update(*args, **kw):
        return None

    monkeypatch.setattr(pcaa, "adam_update_", no_update)
    monkeypatch.setattr(pcaa, "fused_adam_tree_update", lambda grads, count, *a, **k: count + 1)
    monkeypatch.setattr(orced, "adam_update_", no_update)
    result = run(workload)
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_answer_altered():
    assert run("pcaa_v4.eval_b256", fault="altered")["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["pcaa_v4.train_b16", "orced.train_b16",
                                      "pcaa_v4.eval_b256"])
def test_control_fails_on_the_card(workload, cuda):
    """The reference in TF32 (the precision below the configuration's f32)
    in the program's place fails at least one limit, at the cell's size."""
    ctx = harness.load_context(workload, SEED, cuda)
    cache = {}
    calibrate.readings(ctx, "program", cache)
    nums = calibrate.readings(ctx, "control", cache)
    assert any(v > ctx.limits[k] for k, v in nums.items()), nums
