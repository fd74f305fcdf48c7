"""The program's recorder (``utils/profiling.py``): spans and counters off
and on, the host syncs charged to the innermost span, the spans in a
``trace`` export, and the spans that both trainers' epochs and
``batched_apply`` record, with results bitwise those of a run with the
recorder off.

The tests marked ``gpu`` need a CUDA card and skip themselves elsewhere:
the spans share torch.profiler's clock with the card's kernels, and the
sync counter counts a ``.item()``. This file imports no JAX, so that on a
machine with a card and without JAX it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_profiling.py``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import batched_apply
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import build_orced, make_orced_epoch_fns
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, build_pcaa, make_epoch_fns
from opensetgaitrecognition_pcaa_tpu_torch.utils import profiling
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, recording, span, trace

DIMS = dict(NMAX=16, NSTEPS=8, CROP_STEP=4, POINTNET_OUT_DIM=32,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=8, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=4, SUPERVISION_FREQUENCY=2)
STEPS = 3
V4_STEP = ["train.gather", "train.encoder", "train.critic", "train.critic_adam", "train.losses",
           "train.backward", "train.adam", "train.metrics"]
ORCED_STEP = ["train.gather", "train.encoder", "train.losses", "train.backward", "train.adam",
              "train.metrics"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def children(rec, parent):
    return [s[0] for s in rec.spans if s[1] == parent]


def _data():
    rng = np.random.default_rng(0)
    n = STEPS * DIMS["BATCH_SIZE"]
    x = rng.normal(size=(n, DIMS["NSTEPS"], DIMS["NMAX"], 4)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    perm = rng.permutation(n).reshape(STEPS, DIMS["BATCH_SIZE"])
    return torch.from_numpy(x), torch.from_numpy(y), perm


def _v4_epoch(**flags):
    """One tiny V4 epoch, by default with the kernels' options on (their
    plain paths on the CPU) → (metrics, the modules' tensors and both Adam
    states)."""
    flags = {"FUSED_POINTNET": True, "FUSED_ADAM": True, **flags}
    cfg = Config(MODEL_NAME="PROF_V4", **DIMS, **flags)
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
    train_epoch, _ = make_epoch_fns(mods, cfg)
    state, m = train_epoch(state, *_data())
    tensors = {f"m.{k}": v for k, v in mods.state_dict().items()}
    for name, o in (("g", state.opt_g), ("d", state.opt_d)):
        tensors.update({f"{name}.mu.{k}": v for k, v in o.mu.items()})
        tensors.update({f"{name}.nu.{k}": v for k, v in o.nu.items()})
    return m, tensors


# --- the recorder ------------------------------------------------------------------------------

def test_off_records_nothing_through_one_shared_object():
    assert profiling._recorder is None
    a, b = span("train.step"), span("eval.h2d")
    assert a is b is profiling._OFF
    with a:
        with b:
            count("train.steps")
    assert profiling._recorder is None


def test_on_records_nested_spans_and_restores_off_after_an_exception():
    with pytest.raises(ValueError):
        with recording() as rec:
            with span("outer"):
                with span("inner"):
                    count("n", 2)
                with span("second"):
                    raise ValueError("inside a span")
    assert [(s[0], s[1]) for s in rec.spans] == [("outer", -1), ("inner", 0), ("second", 0)]
    (_, _, a0, b0), (_, _, a1, b1), (_, _, a2, b2) = rec.spans
    assert a0 <= a1 <= b1 <= a2 <= b2 <= b0 and b2 > 0
    assert rec.counters == {"n": 2}
    assert profiling._recorder is None and span("x") is profiling._OFF


def test_count_adds_nothing_off_and_sums_per_name_on():
    count("before", 5)
    with recording() as rec:
        count("a")
        count("b", 3)
        count("a", 2)
    count("after")
    assert rec.counters == {"a": 3, "b": 3}


def test_a_second_recording_is_refused():
    with recording():
        with pytest.raises(RuntimeError, match="open already"):
            with recording():
                pass
    assert profiling._recorder is None


def test_syncs_are_charged_to_the_innermost_span(monkeypatch):
    """The warnings of ``set_sync_debug_mode("warn")``, as a CUDA build
    gives them, emulated on the CPU: each charged to the span open when it
    came, and any other warning shown again after the block."""
    mode = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", mode.append)

    def sync():
        warnings.warn("called a synchronizing CUDA operation")

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with recording() as rec:
            assert mode == ["warn"]
            sync()
            with span("step"):
                sync()
                with span("losses"):
                    sync()
                    sync()
                    warnings.warn("something else")
                with span("adam"):
                    pass
    assert mode == ["warn", 0]
    assert rec.syncs == {-1: 1, 0: 1, 1: 2}
    assert [str(w.message) for w in shown] == ["something else"]


def test_trace_export_holds_the_programs_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with span("prog.phase"):
            torch.mm(torch.randn(16, 16), torch.randn(16, 16))
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "prog.phase" in names
    assert profiling._recorder is None


# --- the spans of the program ------------------------------------------------------------------

def test_v4_epoch_records_each_steps_phases_in_order():
    with recording() as rec:
        _v4_epoch()
    (epoch,) = [i for i, s in enumerate(rec.spans) if s[0] == "train.epoch"]
    assert rec.spans[epoch][1] == -1
    assert children(rec, epoch) == (["train.epoch_setup"] + ["train.step"] * STEPS
                                    + ["train.epoch_stack"])
    steps = [i for i, s in enumerate(rec.spans) if s[0] == "train.step"]
    for i in steps:
        assert children(rec, i) == V4_STEP
    assert rec.counters == {"train.steps": STEPS}
    assert all(a <= b for _, _, a, b in rec.spans)


def test_v4_deferred_epoch_records_the_pending_writes_and_the_flush():
    with recording() as rec:
        _v4_epoch(FUSED_ADAM=False, DEFERRED_DECODER_UPDATE=True)
    (epoch,) = [i for i, s in enumerate(rec.spans) if s[0] == "train.epoch"]
    assert children(rec, epoch) == (["train.epoch_setup"] + ["train.step"] * STEPS
                                    + ["train.deferred_flush", "train.epoch_stack"])
    steps = [i for i, s in enumerate(rec.spans) if s[0] == "train.step"]
    assert children(rec, steps[0]) == V4_STEP
    for i in steps[1:]:  # the previous step's decoder write first
        assert children(rec, i) == V4_STEP[:1] + ["train.deferred_write"] + V4_STEP[1:]


def test_orced_epoch_records_each_steps_phases_in_order():
    cfg = Config(MODEL_NAME="PROF_ORCED", **DIMS)
    mods, state = build_orced(cfg, device="cpu")
    train_epoch, _ = make_orced_epoch_fns(mods, cfg)
    with recording() as rec:
        train_epoch(state, *_data(), 0.5)
    (epoch,) = [i for i, s in enumerate(rec.spans) if s[0] == "train.epoch"]
    assert children(rec, epoch) == (["train.epoch_setup"] + ["train.step"] * STEPS
                                    + ["train.epoch_stack"])
    for i in (i for i, s in enumerate(rec.spans) if s[0] == "train.step"):
        assert children(rec, i) == ORCED_STEP
    assert rec.counters == {"train.steps": STEPS}


def test_batched_apply_records_each_chunks_copy_forward_and_copy_back():
    x = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    with recording() as rec:
        a, b = batched_apply(lambda c: (c.sum(1), c * 2), x, 3, torch.device("cpu"))
    np.testing.assert_array_equal(b, x * 2)
    (call,) = [i for i, s in enumerate(rec.spans) if s[0] == "eval.call"]
    assert children(rec, call) == ["eval.h2d", "eval.encoder", "eval.d2h"] * 3 + ["eval.concat"]
    assert rec.counters == {"eval.chunks": 3}


def test_v4_epoch_is_bitwise_the_same_with_the_recorder_on():
    m_off, s_off = _v4_epoch()
    with recording():
        m_on, s_on = _v4_epoch()
    assert m_off.keys() == m_on.keys() and s_off.keys() == s_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


# --- on the card -------------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_spans_share_the_profilers_clock_on_the_card():
    """A sleep kernel launched inside a span, with the span waiting for it,
    lies inside the span converted to the trace's µs; the span's
    ``record_function`` mirror starts within 20 µs of its stamp."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _needs_card()
    torch.cuda._sleep(1000)  # the CUDA context and the kernel's first launch
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):  # the first pass warms the profiler's and the mirror's first calls
        with profile(activities=acts) as prof:
            with recording() as rec:
                with span("clock.sleep"):
                    torch.cuda._sleep(2_000_000)  # about a millisecond at the card's clock
                    torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (_, _, a_ns, b_ns), = rec.spans
    a, b = (a_ns - start_ns) / 1e3, (b_ns - start_ns) / 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    (k,) = [e for e in kernels if "sleep" in e.name.lower() or "spin" in e.name.lower()]
    assert a - 50 <= k.time_range.start and k.time_range.end <= b + 50, (a, b, k.time_range)
    assert k.time_range.end - k.time_range.start > 100
    (mirror,) = [e for e in prof.events() if e.name == "clock.sleep"
                 and e.device_type == DeviceType.CPU]
    assert abs(mirror.time_range.start - a) <= 20, (mirror.time_range.start, a)


@pytest.mark.gpu
def test_syncs_are_counted_on_the_card():
    _needs_card()
    x = torch.ones(4096, device="cuda")
    (x * 2).sum().item()
    with recording() as rec:
        with span("reads"):
            x.sum().item()
        with span("launches"):
            for _ in range(4):
                x = x * 2
            x.sum()
    assert [s[0] for s in rec.spans] == ["reads", "launches"]
    assert rec.syncs.get(0, 0) == 1 and rec.syncs.get(1, 0) == 0, rec.syncs
    assert torch.cuda.get_sync_debug_mode() == 0
