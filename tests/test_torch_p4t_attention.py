"""The P4Transformer blocks' attention (``ops/p4t_attention.py``) on the
CPU: the op is the view, ``F.scaled_dot_product_attention`` and the
reshape there, bit for bit with its autograd; on the card it refuses with
words what its kernels do not take; the launch counter and the kernels'
arguments through a stand-in library; the model's card path holds no
library attention; and the benchmark's roofline of attention counted by
hand. No JAX."""

import contextlib
import inspect
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, tracing
from benchmark.tests.test_bench_p4t import DIMS
from opensetgaitrecognition_pcaa_tpu_torch.models import p4t
from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_attention as pa
from opensetgaitrecognition_pcaa_tpu_torch.utils import profiling


def _qkv(b, n, heads, dh, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, 3 * heads * dh), generator=gen, dtype=dtype)


@pytest.mark.parametrize("b,n,heads,dh", [(2, 15, 2, 8), (1, 1, 1, 4), (3, 33, 4, 16)])
def test_cpu_path_is_the_view_sdpa_and_reshape(b, n, heads, dh):
    """Bit for bit what ``Block.forward`` computed inline before the op,
    forward and gradient, and no launch."""
    qkv = _qkv(b, n, heads, dh).requires_grad_()
    twin = qkv.detach().clone().requires_grad_()
    g = torch.randn((b, n, heads * dh), generator=torch.Generator().manual_seed(1))
    pa.p4t_attention.launches = 0
    got = pa.p4t_attention(qkv, heads, dh)
    q, k, v = twin.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    want = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, heads * dh)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, qkv, g)[0], torch.autograd.grad(want, twin, g)[0])
    assert pa.p4t_attention.launches == 0


def test_cpu_path_is_attention():
    """Against softmax(q kᵀ / √dh) v in f64, q, k, v in that order, heads of
    dim_head along the last dimension."""
    b, n, heads, dh = 2, 7, 3, 4
    qkv = _qkv(b, n, heads, dh, dtype=torch.float64)
    q, k, v = (qkv[..., i * heads * dh:(i + 1) * heads * dh].reshape(b, n, heads, dh)
               for i in range(3))
    s = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(dh)
    want = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, -1), v).reshape(b, n, heads * dh)
    torch.testing.assert_close(pa.p4t_attention(qkv, heads, dh), want)


@pytest.mark.parametrize("case,words", [
    ("not_3d", r"must be \(B, n"),
    ("width", "is not 3 x heads"),
    ("dim_head", "take dim_head in"),
    ("no_tokens", "no tokens"),
    ("no_crops", "no tokens"),
    ("float64", "float32 only"),
    ("not_contiguous", "contiguous"),
    ("misaligned", "16-byte aligned"),
    ("too_many_heads", "at most 65535"),
])
def test_card_refuses_with_words(case, words):
    """``check_args`` is what the op runs on a CUDA tensor before any
    launch; the CPU tensors here stand in for the card's."""
    heads, dh = 2, 128
    qkv = _qkv(1, 5, heads, dh)
    if case == "not_3d":
        qkv = qkv[0]
    elif case == "width":
        qkv = qkv[..., :-4]
    elif case == "dim_head":
        heads, dh = 4, 64
    elif case == "no_tokens":
        qkv = qkv[:, :0]
    elif case == "no_crops":
        qkv = qkv[:0]
    elif case == "float64":
        qkv = qkv.double()
    elif case == "not_contiguous":
        qkv = _qkv(1, 10, heads, dh)[:, ::2]
    elif case == "misaligned":
        qkv = torch.zeros(1 + 5 * 3 * heads * dh)[1:].view(1, 5, 3 * heads * dh)
    elif case == "too_many_heads":
        heads = 65536
        qkv = torch.empty((1, 1, 3 * heads * dh), device="meta")
    with pytest.raises(ValueError, match=words):
        pa.check_args(qkv, heads, dh)


def test_card_takes_the_cells_shape():
    pa.check_args(torch.empty((16, 1125, 3 * 8 * 128)), 8, 128)


def test_other_devices_refuse():
    with pytest.raises(ValueError, match="no kernel for device"):
        pa.p4t_attention(torch.empty((1, 2, 3 * 128), device="meta"), 1, 128)


class _Library:
    """Stands in for the built library: records each entry's integer
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def p4t_attention_forward(self, *args):
        self.calls.append(("forward", args[3:7]))
        return 0

    def p4t_attention_backward(self, *args):
        self.calls.append(("backward", args[6:10]))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(pa, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    return lib


def test_launches_as_the_docstring_says(stand_in):
    """A forward is 1 launch, a backward 3, on the wrapper's counter and on
    the program counter of the same name; the entries get (B, n, heads,
    dim_head), and the gradient of qkv has qkv's shape."""
    b, n, heads, dh = 2, 9, 3, 128
    qkv = _qkv(b, n, heads, dh).requires_grad_()
    pa.p4t_attention.launches = 0
    with profiling.recording() as rec:
        out = pa.P4TAttention.apply(qkv, heads, dh)
        assert out.shape == (b, n, heads * dh)
        assert pa.p4t_attention.launches == 1
        (grad,) = torch.autograd.grad(out, qkv, torch.ones_like(out))
    assert grad.shape == qkv.shape
    assert pa.p4t_attention.launches == 4
    assert rec.counters["p4t_attention.launches"] == 4
    assert stand_in.calls == [("forward", (b, n, heads, dh)), ("backward", (b, n, heads, dh))]
    assert "forward is 1, a\nbackward 3" in pa.__doc__


def test_a_failed_launch_raises():
    with pytest.raises(RuntimeError, match="backward kernel launch failed: cudaError 1"):
        pa._raise(1, "backward")
    pa._raise(0, "forward")


def test_models_card_path_holds_no_library_attention():
    """``models/p4t.py`` calls no SDPA, no ``sdpa_kernel`` and no ATen
    attention op: ``Block`` reaches attention through ``p4t_attention``
    alone, which keeps SDPA for CPU tensors."""
    source = inspect.getsource(p4t)
    for needle in ("scaled_dot_product_attention(", "sdpa_kernel", "SDPBackend",
                   "_efficient_attention", "_flash_attention", "torch.ops.aten"):
        assert needle not in source, needle
    block = inspect.getsource(p4t.Block.forward)
    assert "p4t_attention(qkv, self.heads, self.dim_head)" in block
    wrapper = inspect.getsource(pa.p4t_attention)
    assert wrapper.index('"cpu"') < wrapper.index("attention_ref") < wrapper.index("check_args")


# the benchmark's roofline of attention (metrics/p4t_attention_roofline.py)
ROOFLINE = harness.metric_reader("p4t_attention_roofline")
step_bound = ROOFLINE.__globals__["step_bound"]  # the reader's module, loaded by path
NAMES = ("(anonymous namespace)::p4t_attention_fwd_kernel(CUtensorMap_st, (anonymous "
         "namespace)::Args)",
         "(anonymous namespace)::p4t_attention_delta_kernel(float const*, float const*, float*, "
         "int, int, int)",
         "(anonymous namespace)::p4t_attention_dkdv_kernel(CUtensorMap_st, CUtensorMap_st, "
         "(anonymous namespace)::Args)",
         "(anonymous namespace)::p4t_attention_dq_kernel(CUtensorMap_st, (anonymous "
         "namespace)::Args)")
LIBRARY = ("fmha_cutlassB_f32_aligned_128x64_k128_sm80_PyTorchMemEffAttention",
           "fmha_cutlassF_f32_aligned_64x128_rf_sm80_PyTorchMemEffAttention")


def test_attention_step_bound_by_hand():
    # 16 crops x 8 heads, n = 1,125, dh = 128, 5 blocks: 12 n² dh a head
    flops = 12 * 1125 ** 2 * 128 * 16 * 8 * 5
    assert flops == 1_244_160_000_000  # 1.245 TFLOP a step
    # both passes are bound by their operations: at the one-pass TF32 peak, 2.51 ms
    assert step_bound(DIMS, 16) == pytest.approx(flops / 495e12, rel=1e-12)
    assert flops / 495e12 == pytest.approx(2.5135e-3, abs=1e-6)


def test_attention_kernels_are_the_programs_own():
    assert tracing.fragments("p4t_attention") == ("p4t_attention",)
    for name in NAMES:
        assert tracing.kind(name) == "port"
        assert tracing.is_port_kernel(name, "p4t_attention")
        for part in ("p4t_linear", "pointnet_train", "pointnet_infer", "adam"):
            assert not tracing.is_port_kernel(name, part), (name, part)
    for name in LIBRARY:  # the library's kernels it replaces stay GEMMs, not attention's
        assert tracing.kind(name) == "gemm"
        assert not tracing.is_port_kernel(name, "p4t_attention")


def test_attention_share_over_the_kernels_device_time():
    """Two steps' bound over the device time of the p4t_attention kernels
    alone; None where a segment ran none (the parent's, the library's)."""
    steps = 2
    bound_s = step_bound(DIMS, 16) * steps
    spent_us = 8 * bound_s * 1e6  # the kernels at an eighth of the one-pass bound
    kernels = [(NAMES[0], 0.0, spent_us / 4), (NAMES[1], 0.0, spent_us / 8),
               (NAMES[2], 0.0, spent_us / 2), (NAMES[3], 0.0, spent_us / 8),
               (LIBRARY[0], 0.0, 1e6)]
    cell = {"dims": DIMS, "batch": 16}
    trace = tracing.Trace(kernels=kernels, window_s=1.0, work={"steps": steps}, cell=cell)
    assert ROOFLINE(trace) == pytest.approx(12.5)
    assert ROOFLINE(tracing.Trace(kernels=kernels[4:], window_s=1.0, work={"steps": steps},
                                  cell=cell)) is None
