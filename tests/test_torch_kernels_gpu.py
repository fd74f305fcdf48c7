"""The CUDA kernels against their plain PyTorch versions, and the wrappers'
argument checks.

The tests marked ``gpu`` need a CUDA card and skip themselves elsewhere.
This file imports neither JAX nor the other test files, so that on a
machine with a card and without JAX it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer, seq_chamfer


def _folded(rng, c: int, d: int, device: str = "cpu", h=None):
    h = d // 2 if h is None else h
    out = {}
    for i, (a, b) in enumerate([(c, h), (h, h), (h, d), (d, d)], start=1):
        out[f"w{i}"] = (rng.uniform(-1, 1, (a, b)) / np.sqrt(max(a, 1))).astype(np.float32)
        out[f"b{i}"] = (rng.uniform(-1, 1, b) / np.sqrt(max(a, 1))).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,d,h",
    [((2, 3, 150, 4), 1024, None), ((1, 97, 37, 4), 1024, None), ((3, 5, 33, 4), 512, None),
     ((2, 3, 1, 4), 1024, None), ((4, 5, 16, 4), 1024, None), ((3, 7, 150, 4), 512, None),
     ((2, 3, 150, 5), 1024, None), ((4, 12, 64, 4), 32, None), ((4, 12, 64, 4), 64, None),
     ((2, 3, 37, 4), 200, None), ((2, 3, 150, 4), 1536, None), ((2, 3, 37, 3), 30, None),
     ((2, 3, 37, 5), 201, None), ((1, 1, 1, 4), 1024, None), ((1, 13, 16, 5), 512, None),
     ((3, 37, 150, 4), 512, 96), ((2, 5, 16, 5), 1024, 260), ((1, 3, 150, 4), 512, 512)],
    ids=["n150", "ragged_f97_n37", "d512", "n1", "n16_no_padding", "d512_n150", "c5",
         "d32", "d64", "d200", "d1536", "c3_d30_padded", "c5_d201_padded", "f1_n1",
         "c5_d512_n16_f13", "h96_d512_f111", "c5_h260", "h_equals_d"],
)
def test_kernel_matches_plain(shape, d, h):
    """The frames here give 16 to 17,760 padded rows, most of them not a
    multiple of the engine's 256-row tile."""
    _needs_card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    folded = _folded(rng, shape[-1], d, "cuda", h)
    before = pn.pointnet_pool_infer.launches
    got = pn.pointnet_pool_infer(x, folded)
    torch.cuda.synchronize()
    assert pn.pointnet_pool_infer.launches == before + 1
    # same bound as bench.py's kernel-parity check
    torch.testing.assert_close(got, pn.pointnet_pool_ref(x, folded), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,c,d,h", [(150, 4, 1024, None), (1, 5, 512, None), (16, 4, 512, 96), (37, 5, 1024, 260)],
    ids=["n150", "n1_c5_d512", "n16_h96", "n37_c5_h260"],
)
def test_kernel_rows_do_not_depend_on_the_batch(monkeypatch, n, c, d, h):
    """A frame's pooled row is the same bits alone, in a larger batch and
    when the batch is walked in several passes (of 7 frames: 103 passes,
    most of them not a whole number of the engine's 256-row tiles)."""
    _needs_card()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(24, 30, n, c)).astype(np.float32)).cuda()
    folded = _folded(rng, c, d, "cuda", h)
    whole = pn.pointnet_pool_infer(x, folded)
    alone = torch.cat([pn.pointnet_pool_infer(x[i:i + 1, 3:11], folded) for i in (0, 5, 23)])
    monkeypatch.setattr(pn, "_PASS_ROWS", 7 * (-(-n // 16) * 16))
    passes = pn.pointnet_pool_infer(x, folded)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[[0, 5, 23], 3:11])
    assert torch.equal(passes, whole)


@pytest.mark.gpu
def test_kernel_is_deterministic():
    """Two calls on a 256-crop chunk give the same bits."""
    _needs_card()
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(size=(256, 30, 150, 4)).astype(np.float32)).cuda()
    folded = _folded(rng, 4, 1024, "cuda")
    first = pn.pointnet_pool_infer(x, folded)
    second = pn.pointnet_pool_infer(x, folded)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_epilogue_elu_is_f_elu_on_every_float():
    """The branch-free ELU of ``csrc/hopper.cuh``, which the eval kernel's
    epilogues and the bf16 layer kernel's prologue inline, against F.elu on
    all 2^32 f32 bit patterns, in chunks: equal values everywhere, a NaN for
    a NaN (expm1f(-0) is -0 where the kernel gives +0, an equal value).
    Equal h is what keeps the bf16 layer's y within one bf16 step of the
    plain version's."""
    _needs_card()
    chunk = 1 << 28
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int64, device="cuda")
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)
        x = bits.view(torch.float32)
        got, want = pn.epilogue_elu(x), torch.nn.functional.elu(x)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        bad = (~same).nonzero()
        assert bad.numel() == 0, (start, x[bad[:5, 0]].tolist(), got[bad[:5, 0]].tolist(),
                                  want[bad[:5, 0]].tolist())
        del bits, x, got, want, same


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,h", [(4, 1024, None), (8, 200, 100), (12, 36, 20)],
                         ids=["main_path", "d200_h100", "c12_d36_h20"])
def test_split_planes_are_the_emulations_bits(c, d, h):
    """The kernel's (hi, lo) planes of each transposed weight equal
    ``ops/tf32x3.py::split_tf32`` bit for bit, over random values and values
    on TF32's rounding ties, signed zeros, the least normal and a large one."""
    _needs_card()
    from opensetgaitrecognition_pcaa_tpu_torch.ops.tf32x3 import split_tf32

    rng = np.random.default_rng(16)
    folded = _folded(rng, c, d, "cpu", h)
    w4 = folded["w4"].view(-1).view(torch.int32)
    # 1 + 2^-11 (a tie), its negative, 1 + 3 * 2^-11 (a tie), the least normal,
    # 2^127, +0, -0, 2 - 2^-11 (a tie that carries into the exponent)
    special = torch.tensor([0x3F801000, -0x407FF000, 0x3F803000, 0x00800000, 0x7F000000,
                            0x00000000, -0x80000000, 0x3FFFF000], dtype=torch.int32)
    w4[:len(special)] = special
    cuda = {k: v.cuda() for k, v in folded.items()}
    planes = pn.split_planes(cuda).cpu()
    at = 0
    for k in ("w1", "w2", "w3", "w4"):
        w = folded[k].t().contiguous()
        for want in split_tf32(w):
            got = planes[at:at + w.numel()].view(w.shape)
            at += w.numel()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
    assert at == planes.numel()


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back():
    _needs_card()
    rng = np.random.default_rng(1)
    folded = _folded(rng, 4, 1024, "cuda")
    x = torch.from_numpy(rng.normal(size=(1, 2, 8, 4)).astype(np.float32)).cuda()
    with pytest.raises(ValueError, match="float32"):
        pn.pointnet_pool_infer(x.double(), folded)
    with pytest.raises(ValueError, match="is on cpu"):
        pn.pointnet_pool_infer(x, {**folded, "w2": folded["w2"].cpu()})


def _cpu_case(d=1024, c=4):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 2, 8, c)).astype(np.float32))
    return x, _folded(rng, c, d)


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda x, f: (x.double(), f), "float32"),
        (lambda x, f: (x.transpose(1, 2), f), "contiguous"),
        (lambda x, f: (x[0], f), r"\(B, T, N, C\)"),
        (lambda x, f: (x, {**f, "w3": f["w3"][:, :-1].contiguous()}), "w3 has shape"),
        (lambda x, f: (x, {**f, "b4": f["b4"][:-1]}), "b4 has shape"),
        (lambda x, f: (x[:, :, :0], f), "no points"),
    ],
    ids=["dtype", "contiguity", "rank", "w3_shape", "b4_shape", "no_points"],
)
def test_argument_checks(mutate, match):
    x, folded = _cpu_case()
    x, folded = mutate(x, folded)
    with pytest.raises(ValueError, match=match):
        pn._check_cuda_args(x, folded)


@pytest.mark.parametrize("d,c", [(256, 4), (2048, 4), (1024, 0)], ids=["d256", "d2048", "c0"])
def test_argument_checks_width_limits(d, c):
    """The kernel takes any width (the wrapper pads to multiples of 4), and
    at least one channel."""
    x, folded = _cpu_case(d, c)
    if c == 0:
        with pytest.raises(ValueError):
            pn._check_cuda_args(x, folded)
    else:
        assert pn._check_cuda_args(x, folded) == d


@pytest.mark.parametrize("c", [5, 300], ids=["c5", "c300"])
def test_argument_checks_accept_any_channel_count(c):
    """The kernel pads the channels to a multiple of 4; it has no C limit."""
    x, folded = _cpu_case(1024, c)
    assert pn._check_cuda_args(x, folded) == 1024


def test_argument_checks_accept_main_path_shapes():
    x, folded = _cpu_case()
    assert pn._check_cuda_args(x, folded) == 1024


def test_split_planes_and_elu_refuse_cpu_tensors():
    x, folded = _cpu_case()
    with pytest.raises(ValueError, match="CUDA"):
        pn.split_planes(folded)
    with pytest.raises(ValueError, match="CUDA"):
        pn.epilogue_elu(x)


def test_no_kernel_for_other_devices():
    x, folded = _cpu_case()
    with pytest.raises(ValueError, match="no kernel"):
        pn.pointnet_pool_infer(x.to("meta"), folded)


# --- train-mode PointNet: layer kernel (+ statistics) and pool kernel ------

def _layer_case(rng, rows, c_in, c_out, with_affine, device="cuda"):
    h = rng.normal(size=(rows, c_in)).astype(np.float32)
    w = (rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, c_out).astype(np.float32)
    out = [torch.from_numpy(a).to(device) for a in (h, w, b)]
    affine = None
    if with_affine:
        affine = torch.from_numpy(np.stack([
            rng.normal(0, 0.5, c_in), rng.uniform(0.5, 2.0, c_in), rng.normal(0, 0.3, c_in),
        ]).astype(np.float32)).to(device)
    return out[0], affine, out[1], out[2]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,c_in,c_out,with_affine",
    [(222, 4, 16, False), (222, 16, 20, True), (5000, 512, 512, True), (3001, 1024, 1024, True),
     (6, 4, 512, False), (6, 512, 1024, True), (300, 36, 132, True), (72000, 4, 512, False),
     (222, 5, 512, False), (222, 5, 15, False), (222, 15, 15, True), (222, 15, 30, True),
     (222, 30, 30, True)],
    ids=["ragged_2x3x37_k4", "ragged_cols", "w512", "w1024", "n1_k4", "n1_w1024",
         "ragged_k36_n132", "train_rows_k4", "nfeatures5", "nfeatures5_out15", "w15",
         "w15_30", "w30"],
)
def test_layer_kernel_matches_plain(rows, c_in, c_out, with_affine):
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(3), rows, c_in, c_out, with_affine)
    before = pt.fused_layer.launches
    got = pt.fused_layer(h, affine, w, b)
    torch.cuda.synchronize()
    assert pt.fused_layer.launches == before + 1
    want = pt.fused_layer_ref(h, affine, w, b)
    # f32 sums in another order (y), f64 against f32 column sums (stats)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_layer_kernel_is_deterministic():
    """No atomics: the same inputs give the same bits, statistics included."""
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(15), 5000, 512, 1024, True)
    first = pt.fused_layer(h, affine, w, b)
    second = pt.fused_layer(h, affine, w, b)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 37, 16), (97, 150, 1024)], ids=["ragged", "n150_d1024"])
def test_pool_kernel_matches_plain(shape):
    _needs_card()
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    d = shape[-1]
    affine = torch.from_numpy(np.stack([
        rng.normal(0, 0.5, d), rng.uniform(0.5, 2.0, d), rng.normal(0, 0.3, d),
    ]).astype(np.float32)).cuda()
    before = pt.fused_pool.launches
    got = pt.fused_pool(y, affine)
    torch.cuda.synchronize()
    assert pt.fused_pool.launches == before + 1
    torch.testing.assert_close(got, pt.fused_pool_ref(y, affine), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "widths",
    [[(4, 8), (8, 8), (8, 16), (16, 16)], [(5, 15), (15, 15), (15, 30), (30, 30)]],
    ids=["w4_16", "nfeatures5_d30_padded"],
)
def test_pointnet_train_gradients_on_the_card(widths):
    """The autograd Function through the kernels against autograd through
    the plain version, on the card (tolerances as in the CPU test); also at
    NFEATURES = 5 and POINTNET_OUT_DIM = 30, whose widths the layer
    wrapper pads to multiples of 4: the statistics and gradients come back
    at the real widths."""
    _needs_card()
    rng = np.random.default_rng(5)
    c, d = widths[0][0], widths[-1][1]
    x = rng.normal(size=(2, 3, 37, c)).astype(np.float32)
    layers = [((rng.uniform(-1, 1, (a, c)) / np.sqrt(a)).astype(np.float32),
               rng.uniform(-0.1, 0.1, c).astype(np.float32),
               (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
               (0.1 * rng.normal(size=c)).astype(np.float32)) for a, c in widths]
    cot = torch.from_numpy(rng.normal(size=(2, 3, d)).astype(np.float32)).cuda()
    grads = []
    before = pt.fused_layer.launches
    for fn in (pt.pointnet_pool_train, pt.pointnet_pool_train_ref):
        params = [[torch.tensor(a, device="cuda", requires_grad=True) for a in layer]
                  for layer in layers]
        xt = torch.tensor(x, device="cuda", requires_grad=True)
        pooled, means, variances = fn(xt, params)
        torch.sum(pooled * cot).backward()
        grads.append([pooled, *means, *variances, xt.grad]
                     + [p.grad for i, layer in enumerate(params) for p in layer])
    assert pt.fused_layer.launches == before + 4
    names = ["pooled"] + [f"stat{i}" for i in range(8)] + ["x"] + [
        f"{n}{i}" for i in range(4) for n in ("W", "b", "gamma", "beta")]
    for name, got, want in zip(names, *grads):
        assert got.shape == want.shape, name
        # the bias ahead of a train-mode BatchNorm has a zero gradient: noise only
        tol = dict(rtol=0, atol=5e-6) if name.startswith("b") and name[1:].isdigit() else \
            dict(rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.detach(), want.detach(), msg=name, **tol)


@pytest.mark.gpu
def test_pointnet_train_raises_instead_of_falling_back():
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(6), 64, 8, 8, True)
    with pytest.raises(ValueError, match="float32"):
        pt.fused_layer(h.double(), affine, w, b)
    with pytest.raises(ValueError, match="is on cpu"):
        pt.fused_layer(h, affine, w.cpu(), b)


# --- the bf16 variants of the train-mode PointNet kernels ------------------

BF16 = torch.bfloat16
# one bf16 rounding step (8 significant bits) apart, at most, and near
# zero the f32 sum order's error, as the f32 layer kernel's test allows
BF16_STEP = dict(rtol=2.0**-7, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,c_in,c_out,with_affine",
    [(222, 4, 16, False), (222, 16, 24, True), (5000, 512, 512, True), (3001, 1024, 1024, True),
     (6, 4, 512, False), (6, 512, 1024, True), (300, 36, 132, True), (72000, 4, 512, False),
     (222, 5, 512, False), (222, 5, 15, False), (222, 15, 15, True), (222, 15, 30, True),
     (222, 30, 30, True)],
    ids=["ragged_2x3x37_k4", "ragged_cols", "w512", "w1024", "n1_k4", "n1_w1024",
         "ragged_k36_n132", "train_rows_k4", "nfeatures5", "nfeatures5_out15", "w15",
         "w15_30", "w30"],
)
def test_layer_kernel_bf16_matches_plain(rows, c_in, c_out, with_affine):
    """The bf16 layer kernel against its plain version: both round h to bf16
    with the same operations, so y differs only by the order of its f32
    sums: one bf16 rounding step at most where the sum sits on a boundary;
    the statistics are f32 sums of the unrounded y, as at f32."""
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(3), rows, c_in, c_out, with_affine)
    h = h.to(BF16)
    before = pt.fused_layer.launches_bf16
    got = pt.fused_layer(h, affine, w, b)
    torch.cuda.synchronize()
    assert pt.fused_layer.launches_bf16 == before + 1
    want = pt.fused_layer_ref(h, affine, w, b)
    assert got[0].dtype == want[0].dtype == BF16 and got[0].shape == (rows, c_out)
    torch.testing.assert_close(got[0].float(), want[0].float(), **BF16_STEP)
    for g, wt in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, wt, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,c_in,c_out,with_affine",
    [(72000, 512, 512, True), (64 * 5 + 1, 512, 256, True), (37, 64, 256, True),
     (222, 8, 512, False), (222, 8, 512, True), (300, 512, 1536, True), (130, 4096, 256, True)],
    ids=["half_tile_72000", "64k_plus_1", "rows_below_64", "k8", "k8_affine", "n1536",
         "k4096_three_stages"],
)
def test_layer_kernel_bf16_tile_edges(rows, c_in, c_out, with_affine):
    """The bf16 layer kernel where its tiles end: row counts that end a
    64-row warpgroup half but not a 128-row tile (72,000) or one row past a
    half, fewer rows than a half, K = 8 (one 64-wide TMA box, zero past
    K in A, h and W^T) with and without the affine, C_out = 1536 (six
    256-column tiles), and K = 4096, whose staged affine leaves room for 3
    ring stages, not 4; the same bounds as above."""
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(16), rows, c_in, c_out, with_affine)
    h = h.to(BF16)
    before = pt.fused_layer.launches_bf16
    got = pt.fused_layer(h, affine, w, b)
    torch.cuda.synchronize()
    assert pt.fused_layer.launches_bf16 == before + 1
    want = pt.fused_layer_ref(h, affine, w, b)
    assert got[0].dtype == BF16 and got[0].shape == (rows, c_out)
    torch.testing.assert_close(got[0].float(), want[0].float(), **BF16_STEP)
    for g, wt in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, wt, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_layer_kernel_bf16_raises_on_a_misaligned_input():
    """TMA needs 16-byte-aligned bases: a contiguous view of h at a 2-byte
    offset raises, and launches nothing."""
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(17), 64, 16, 16, True)
    flat = torch.empty(64 * 16 + 1, dtype=BF16, device="cuda")
    shifted = flat[1:].view(64, 16)
    shifted.copy_(h.to(BF16))
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = pt.fused_layer.launches_bf16
    with pytest.raises(ValueError, match="16-byte boundary"):
        pt.fused_layer(shifted, affine, w, b)
    assert pt.fused_layer.launches_bf16 == before


@pytest.mark.gpu
def test_layer_kernel_bf16_is_deterministic():
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(15), 5000, 512, 1024, True)
    first = pt.fused_layer(h.to(BF16), affine, w, b)
    second = pt.fused_layer(h.to(BF16), affine, w, b)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 37, 16), (97, 150, 1024)], ids=["ragged", "n150_d1024"])
def test_pool_kernel_bf16_matches_plain(shape):
    _needs_card()
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(BF16)
    d = shape[-1]
    affine = torch.from_numpy(np.stack([
        rng.normal(0, 0.5, d), rng.uniform(0.5, 2.0, d), rng.normal(0, 0.3, d),
    ]).astype(np.float32)).cuda()
    before = pt.fused_pool.launches_bf16
    got = pt.fused_pool(y, affine)
    torch.cuda.synchronize()
    assert pt.fused_pool.launches_bf16 == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, pt.fused_pool_ref(y, affine), rtol=1e-5, atol=1e-6)


def _pool_case(rng, shape):
    d = shape[-1]
    y = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(BF16)
    affine = torch.from_numpy(np.stack([
        rng.normal(0, 0.5, d), rng.uniform(0.5, 2.0, d), rng.normal(0, 0.3, d),
    ]).astype(np.float32)).cuda()
    return y, affine


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((6, 37, 30), 0), ((5, 150, 1000), 0), ((4, 37, 64), 1)],
                         ids=["d30_elementwise", "d1000_partial_block", "misaligned_y"])
def test_pool_kernel_bf16_edges(shape, offset):
    """The bf16 pool's element-by-element path (d not a multiple of 8, or y
    not 16-byte aligned) and a channel block cut by d, at the same bounds
    as above."""
    _needs_card()
    y, affine = _pool_case(np.random.default_rng(18), shape)
    if offset:
        flat = torch.empty(y.numel() + offset, dtype=BF16, device="cuda")
        y = flat[offset:].view(shape).copy_(y)
        assert y.is_contiguous() and y.data_ptr() % 16 == 2 * offset
    before = pt.fused_pool.launches_bf16
    got = pt.fused_pool(y, affine)
    torch.cuda.synchronize()
    assert pt.fused_pool.launches_bf16 == before + 1
    torch.testing.assert_close(got, pt.fused_pool_ref(y, affine), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_pool_kernel_bf16_is_deterministic():
    """The splits' partial sums meet in a fixed order: two launches give
    the same bits."""
    _needs_card()
    y, affine = _pool_case(np.random.default_rng(19), (97, 150, 1024))
    first = pt.fused_pool(y, affine)
    second = pt.fused_pool(y, affine)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("offset", [0, 1, 8], ids=["aligned", "offset_2_bytes", "offset_16_bytes"])
def test_check_aligned(offset):
    """The bf16 layer wrapper's alignment check, on CPU tensors: a base
    that is not a multiple of 16 bytes raises with the tensor's name."""
    flat = torch.zeros(64 + 8 * 8, dtype=BF16)
    base = flat.data_ptr() % 16 // 2  # elements to the first 16-byte boundary
    t = flat[(8 - base) % 8 + offset:][:64].view(8, 8)
    if offset % 8:
        with pytest.raises(ValueError, match="h must start on a 16-byte boundary"):
            pt.check_aligned("h", t)
    else:
        pt.check_aligned("h", t)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "widths",
    [[(4, 8), (8, 8), (8, 16), (16, 16)], [(5, 15), (15, 15), (15, 30), (30, 30)]],
    ids=["w4_16", "nfeatures5_d30_padded"],
)
def test_pointnet_train_bf16_on_the_card_equals_the_cpu(widths):
    """The bf16 autograd Function on the card (the bf16 kernels forward,
    cuBLAS's bf16 GEMMs with f32 output backward) against the same Function
    on the CPU (plain versions, f32 GEMMs of the bf16 values): the same
    roundings, sums in other orders, so a bf16 value may sit one step away
    and move what follows; held at rtol 1e-2 with atol 1e-2 of each
    output's scale."""
    _needs_card()
    rng = np.random.default_rng(5)
    c, d = widths[0][0], widths[-1][1]
    x = rng.normal(size=(2, 3, 37, c)).astype(np.float32)
    layers = [((rng.uniform(-1, 1, (a, c)) / np.sqrt(a)).astype(np.float32),
               rng.uniform(-0.1, 0.1, c).astype(np.float32),
               (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
               (0.1 * rng.normal(size=c)).astype(np.float32)) for a, c in widths]
    cot = rng.normal(size=(2, 3, d)).astype(np.float32)
    grads = []
    before = (pt.fused_layer.launches_bf16, pt.fused_pool.launches_bf16)
    for device in ("cuda", "cpu"):
        params = [[torch.tensor(a, device=device, requires_grad=True) for a in layer]
                  for layer in layers]
        xt = torch.tensor(x, device=device, requires_grad=True)
        pooled, means, variances = pt.pointnet_pool_train(xt, params, BF16)
        torch.sum(pooled * torch.from_numpy(cot).to(device)).backward()
        grads.append([t.detach().cpu() for t in [pooled, *means, *variances, xt.grad]
                      + [p.grad for layer in params for p in layer]])
    assert (pt.fused_layer.launches_bf16, pt.fused_pool.launches_bf16) == (
        before[0] + 4, before[1] + 1)
    for i, (got, want) in enumerate(zip(*grads)):
        assert got.shape == want.shape and got.dtype == torch.float32, i
        # a dense bias ahead of a train-mode BatchNorm has a zero gradient
        # up to rounding: held against its layer's W gradient's scale
        scale = want if i < 10 or (i - 10) % 4 != 1 else grads[1][i - 1]
        torch.testing.assert_close(got, want, rtol=1e-2,
                                   atol=1e-2 * float(scale.abs().max()) + 1e-6, msg=str(i))


# --- Adam -------------------------------------------------------------------

def _adam_leaf(rng, shape, device="cuda"):
    g = rng.normal(0, 1e-2, shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    m = rng.normal(0, 1e-3, shape).astype(np.float32)
    v = rng.uniform(0, 1e-4, shape).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (g, w, m, v)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(136, 648), (1001, 3), (2048, 1025)],
                         ids=["leaf_136x648", "ragged_tail3", "big"])
def test_adam_kernel_matches_plain(shape):
    _needs_card()
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    got = _adam_leaf(np.random.default_rng(7), shape)
    want = [t.clone() for t in got]
    before = adam.adam_update_.launches
    adam.adam_update_(*got, **coeffs)
    torch.cuda.synchronize()
    assert adam.adam_update_.launches == before + 1
    adam.adam_update_ref_(*want, **coeffs)
    # the kernel rounds every operation as the plain version does
    for g, wt in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("moments", ["m16", "mv16", "v16"])
@pytest.mark.parametrize("shape", [(136, 648), (1001, 3), (2048, 1025)],
                         ids=["leaf_136x648", "ragged_tail3", "big"])
def test_adam_kernel_bf16_moments_bitwise(moments, shape):
    """The bf16-moment variants (m bf16; m and v bf16; v bf16) round every
    operation and the stored moments (nearest even) as the plain version
    does: the same bits."""
    _needs_card()
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    got = _adam_leaf(np.random.default_rng(7), shape)
    if moments != "v16":
        got[2] = got[2].to(BF16)
    if moments != "m16":
        got[3] = got[3].to(BF16)
    want = [t.clone() for t in got]
    counter = "launches_" + moments
    before = getattr(adam.adam_update_, counter)
    for _ in range(3):
        adam.adam_update_(*got, **coeffs)
        adam.adam_update_ref_(*want, **coeffs)
    torch.cuda.synchronize()
    assert getattr(adam.adam_update_, counter) == before + 3
    for g, wt in zip(got[1:], want[1:]):
        assert g.dtype == wt.dtype and torch.equal(g, wt)


@pytest.mark.gpu
def test_adam_tree_update_sends_only_big_2d_leaves_to_the_kernel():
    _needs_card()
    rng = np.random.default_rng(8)
    leaves = {"big": _adam_leaf(rng, (1024, 2048)), "small": _adam_leaf(rng, (64, 64)),
              "vec": _adam_leaf(rng, (1 << 21,))}
    before = adam.adam_update_.launches
    count = adam.fused_adam_tree_update(
        {k: v[0] for k, v in leaves.items()}, 0, {k: v[2] for k, v in leaves.items()},
        {k: v[3] for k, v in leaves.items()}, {k: v[1] for k, v in leaves.items()},
        lr=1e-4, b1=0.9, b2=0.99,
    )
    torch.cuda.synchronize()
    assert count == 1 and adam.adam_update_.launches == before + 1


@pytest.mark.gpu
def test_adam_raises_instead_of_falling_back():
    _needs_card()
    g, w, m, v = _adam_leaf(np.random.default_rng(9), (64, 64))
    coeffs = dict(s1=1e-3, s2=10.0, b1=0.9, b2=0.99, eps=1e-8)
    with pytest.raises(ValueError, match="float32"):
        adam.adam_update_(g.double(), w, m, v, **coeffs)
    with pytest.raises(ValueError, match="is on cpu"):
        adam.adam_update_(g, w, m.cpu(), v, **coeffs)


@pytest.mark.gpu
@pytest.mark.parametrize("moments", ["m16", "mv16"])
@pytest.mark.parametrize("shape", [(136, 648), (1001, 3), (2048, 1025)],
                         ids=["leaf_136x648", "ragged_tail3", "big"])
def test_adam_kernel_writes_the_bf16_copy_bitwise(moments, shape):
    """The variants of bf16 compute with the copy of w
    (``BF16_WEIGHT_CACHE``): w, m, v and the copy the plain version's bits,
    the copy w rounded to bf16; each launch counted."""
    _needs_card()
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    got = _adam_leaf(np.random.default_rng(7), shape)
    got[2] = got[2].to(BF16)
    if moments == "mv16":
        got[3] = got[3].to(BF16)
    got.append(torch.zeros(shape, device="cuda", dtype=BF16))
    want = [t.clone() for t in got]
    counter = f"launches_{moments}_w16"
    before = getattr(adam.adam_update_, counter)
    for _ in range(3):
        adam.adam_update_(*got[:4], w16=got[4], **coeffs)
        adam.adam_update_ref_(*want[:4], w16=want[4], **coeffs)
    torch.cuda.synchronize()
    assert getattr(adam.adam_update_, counter) == before + 3
    for g, wt in zip(got[1:], want[1:]):
        assert g.dtype == wt.dtype and torch.equal(g, wt)
    assert torch.equal(got[4], got[1].to(BF16))


@pytest.mark.gpu
def test_adam_copy_is_refused_where_no_kernel_writes_it():
    """The copy needs bf16 m (the layouts of bf16 compute) and a bf16,
    aligned tensor of w's shape: else the wrapper raises."""
    _needs_card()
    g, w, m, v = _adam_leaf(np.random.default_rng(9), (64, 64))
    coeffs = dict(s1=1e-3, s2=10.0, b1=0.9, b2=0.99, eps=1e-8)
    w16 = torch.zeros(64, 64, device="cuda", dtype=BF16)
    with pytest.raises(ValueError, match="with a bf16 copy"):
        adam.adam_update_(g, w, m, v, w16=w16, **coeffs)  # f32 moments
    m16 = m.to(BF16)
    with pytest.raises(ValueError, match="w16 must be bfloat16"):
        adam.adam_update_(g, w, m16, v, w16=w16.float(), **coeffs)
    with pytest.raises(ValueError, match="shape"):
        adam.adam_update_(g, w, m16, v, w16=w16[:32], **coeffs)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 64 + 1, device="cuda", dtype=BF16)
        adam.adam_update_(g, w, m16, v, w16=flat[1:].view(64, 64), **coeffs)


@pytest.mark.gpu
def test_adam_tree_update_refreshes_the_cache():
    """``fused_adam_tree_update(cache=)``: the kernel writes the copy of a
    big leaf, the plain version that of a small one."""
    _needs_card()
    rng = np.random.default_rng(8)
    leaves = {"big": _adam_leaf(rng, (1024, 2048)), "small": _adam_leaf(rng, (64, 64))}
    for leaf in leaves.values():
        leaf[2] = leaf[2].to(BF16)
    cache = {k: v[1].to(BF16) for k, v in leaves.items()}
    before = adam.adam_update_.launches_m16_w16
    adam.fused_adam_tree_update(
        {k: v[0] for k, v in leaves.items()}, 0, {k: v[2] for k, v in leaves.items()},
        {k: v[3] for k, v in leaves.items()}, {k: v[1] for k, v in leaves.items()},
        lr=1e-4, b1=0.9, b2=0.99, cache=cache)
    torch.cuda.synchronize()
    assert adam.adam_update_.launches_m16_w16 == before + 1
    for k, leaf in leaves.items():
        assert torch.equal(cache[k], leaf[1].to(BF16)), k


# --- a training step of each PCAA variant ----------------------------------------

# NMAX 64, NSTEPS 12: the decoder's last matrix (1536 x 3072) is the one leaf
# of at least 2^21 elements, so the Adam kernel launches once a step where
# there is a decoder and never for V3
VARIANT_DIMS = dict(NMAX=64, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
                    DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16,
                    TRAIN_CLASSES=(0, 1, 2), BATCH_SIZE=8)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,dph,adam_launches",
                         [("V1", False, 1), ("V2", False, 1), ("V3", False, 0), ("V4", True, 1)],
                         ids=["V1", "V2", "V3", "V4_dph"])
def test_variant_step_kernels_match_plain(variant, dph, adam_launches):
    """One step of each variant from one seeded state, through the kernels
    and plain: losses within 1e-3 relative to max(|plain|, 1), the bound
    of ``chip_smoke.py`` phase 6b, and the kernels' launches counted."""
    import dataclasses

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    _needs_card()
    spec = VARIANTS[VARIATION(variant)]
    if dph:
        spec = dataclasses.replace(spec, use_disc_head=True)
    cfg = Config(**VARIANT_DIMS)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(8, 12, 64, 4)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.arange(8, dtype=np.int32) % 3).cuda()
    noise = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).cuda(),
             torch.from_numpy(rng.uniform(size=(8, 1)).astype(np.float32)).cuda())
    losses = {}
    for fused in (False, True):
        run_cfg = cfg.replace(FUSED_POINTNET=fused, FUSED_ADAM=fused)
        mods, state = build_pcaa(run_cfg, spec, device="cuda")
        counts = (pt.fused_layer.launches, pt.fused_pool.launches, adam.adam_update_.launches)
        _, m = make_train_step(mods, run_cfg)(state, x, y, 0, noise)
        torch.cuda.synchronize()
        now = (pt.fused_layer.launches, pt.fused_pool.launches, adam.adam_update_.launches)
        assert tuple(b - a for a, b in zip(counts, now)) == (
            (4, 1, adam_launches) if fused else (0, 0, 0))
        losses[fused] = {k: float(v) for k, v in m.items()}
        if dph:
            assert state.opt_d.count == 1
            assert not any(state.opt_d.mu[k].any() for k in state.opt_d.mu
                           if k.startswith("disc_head."))
    for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
        plain, kernel = losses[False][key], losses[True][key]
        assert np.isfinite(kernel) and abs(kernel - plain) <= 1e-3 * max(abs(plain), 1.0), key
    assert (losses[True]["rec_loss"] == 0.0) == (variant == "V3")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,nu16", [("bfloat16", False), ("bfloat16", True),
                                        ("float32", True)],
                         ids=["bf16", "bf16_nu16", "f32_nu16"])
def test_v4_step_bf16_kernels_match_plain(dtype, nu16):
    """A V4 step with bf16 storage (``COMPUTE_DTYPE="bfloat16"`` with and
    without ``BF16_ADAM_NU``; f32 with ``BF16_ADAM_NU``) through the
    kernels and plain: losses within 1e-2 relative to max(|plain|, 1)
    (bf16 values one rounding step apart move what follows), the kernel
    variants of the storage launched and no other."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    _needs_card()
    cfg = Config(COMPUTE_DTYPE=dtype, BF16_ADAM_NU=nu16, **VARIANT_DIMS)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(8, 12, 64, 4)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.arange(8, dtype=np.int32) % 3).cuda()
    noise = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).cuda(),
             torch.from_numpy(rng.uniform(size=(8, 1)).astype(np.float32)).cuda())
    mu16 = dtype == "bfloat16"
    adam_counter = {(True, False): "launches_m16", (True, True): "launches_mv16",
                    (False, True): "launches_v16"}[(mu16, nu16)]

    def counts():
        return (pt.fused_layer.launches_bf16, pt.fused_pool.launches_bf16,
                getattr(adam.adam_update_, adam_counter), pt.fused_layer.launches,
                pt.fused_pool.launches, adam.adam_update_.launches)

    losses = {}
    for fused in (False, True):
        run_cfg = cfg.replace(FUSED_POINTNET=fused, FUSED_ADAM=fused)
        mods, state = build_pcaa(run_cfg, VARIANTS[VARIATION.V4], device="cuda")
        before = counts()
        _, m = make_train_step(mods, run_cfg)(state, x, y, 0, noise)
        torch.cuda.synchronize()
        want = ((4, 1, 1, 0, 0, 0) if mu16 else (0, 0, 1, 4, 1, 0)) if fused else (0,) * 6
        assert tuple(b - a for a, b in zip(before, counts())) == want
        assert all((v.dtype == BF16) == mu16 for v in state.opt_g.mu.values())
        assert all((v.dtype == BF16) == nu16 for v in state.opt_g.nu.values())
        losses[fused] = {k: float(v) for k, v in m.items()}
    for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
        plain, kernel = losses[False][key], losses[True][key]
        assert np.isfinite(kernel) and abs(kernel - plain) <= 1e-2 * max(abs(plain), 1.0), key


@pytest.mark.gpu
def test_grid_runs_launch_the_kernels_and_follow_their_solo_runs():
    """Two grid V4 runs (seeds 0 and 1; run 1 with 2 of run 0's 3 steps)
    with the kernels on: (layer, pool, Adam) launches (4, 1, 1) per step
    taken, and each run's per-step losses within 1e-3 relative to
    max(|solo|, 1) of its solo ``train_epoch`` (cuDNN's backward-filter
    sums in a run-dependent order on the card)."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridPCAATrainer
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_epoch_fns,
    )

    _needs_card()
    cfgs = [Config(SEED=r, FUSED_POINTNET=True, FUSED_ADAM=True, **VARIANT_DIMS)
            for r in range(2)]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(24, 12, 64, 4)).astype(np.float32)
    y = (np.arange(24) % 3).astype(np.int32)
    sets = [(x, y), (x[:16], y[:16])]
    trainer = GridPCAATrainer(cfgs, VARIATION.V4, sets, device="cuda")
    before = (pt.fused_layer.launches, pt.fused_pool.launches, adam.adam_update_.launches)
    trainer.run_epoch(0)
    torch.cuda.synchronize()
    now = (pt.fused_layer.launches, pt.fused_pool.launches, adam.adam_update_.launches)
    assert tuple(b - a for a, b in zip(before, now)) == (4 * 5, 5, 5)
    for r, (cfg, (xr, yr)) in enumerate(zip(cfgs, sets)):
        mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
        perm = epoch_batch_indices(len(xr), 8, True, rng=np.random.default_rng(r))
        _, m = make_epoch_fns(mods, cfg)[0](state, torch.from_numpy(xr).cuda(),
                                            torch.from_numpy(yr).cuda(), perm)
        for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
            solo, got = m[key].cpu().numpy(), trainer.last_epoch_steps[r][key].cpu().numpy()
            assert got.shape == solo.shape and np.isfinite(got).all()
            assert (np.abs(got - solo) <= 1e-3 * np.maximum(np.abs(solo), 1.0)).all(), key


# --- Chamfer ------------------------------------------------------------------

CHAMFER_TOL = dict(rtol=1e-5, atol=1e-6)  # kernel against plain


def _clouds(rng, b, t, n, m, device="cuda", c=4):
    """Crop-like clouds: gts zero-padded after a random count of points."""
    gts = rng.normal(size=(b, t, n, c)).astype(np.float32)
    for idx in np.ndindex(b, t):
        gts[idx][rng.integers(max(1, n // 2), n + 1):] = 0.0
    preds = (0.7 * rng.normal(size=(b, t, m, c)) + 0.2).astype(np.float32)
    return torch.from_numpy(preds).to(device), torch.from_numpy(gts).to(device)


def _check_chamfer(got, preds, gts):
    """The kernel rounds each distance as the plain version does, so only
    the order of the sums differs from it (measured 2.8e-7 relative); the
    f64 oracle is held at the JAX package's Chamfer parity bound, since two
    f32 paths of xx + yy - 2xy cancel apart by up to about 2e-4."""
    torch.testing.assert_close(got, frame_chamfer(preds, gts), **CHAMFER_TOL)
    d = ((gts.double()[:, :, :, None] - preds.double()[:, :, None]) ** 2).sum(-1)
    oracle = d.amin(2).sum(2) + d.amin(3).sum(2)
    torch.testing.assert_close(got.double(), oracle, rtol=1e-3, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,t,n,m",
    [(8, 30, 150, 150), (3, 5, 37, 53), (2, 3, 1, 1), (2, 3, 1, 9), (1, 2, 1500, 2100),
     (4, 6, 704, 704), (16, 30, 150, 150), (1, 2, 3000, 4000)],
    ids=["n150", "ragged_n37_m53", "n1", "n1_m9", "two_tiles", "n704", "serving_request",
         "minima_in_scratch"],
)
def test_chamfer_kernel_matches_plain_and_f64(b, t, n, m):
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(10), b, t, n, m)
    before = ck.seq_chamfer_kernel.launches
    got = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    assert ck.seq_chamfer_kernel.launches == before + 1
    _check_chamfer(got, preds, gts)
    for avg_out in (True, False):
        torch.testing.assert_close(ck.seq_chamfer_kernel(preds, gts, avg_out=avg_out),
                                   seq_chamfer(preds, gts, avg_out=avg_out), **CHAMFER_TOL)


@pytest.mark.gpu
def test_chamfer_kernel_is_deterministic():
    """A minimum is exact in any order and the sums of minima have a fixed
    order: two launches give the same bits."""
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(16), 64, 30, 150, 150)
    first = ck.frame_chamfer_kernel(preds, gts)
    second = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_chamfer_frame_does_not_depend_on_the_batch():
    """A frame alone (8 warps a frame) gives the bits it gives inside a
    batch of 1920 frames (1 warp a frame)."""
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(17), 64, 30, 150, 150)
    assert ck.launch_geometry(1, 150, 150, 4).warps != ck.launch_geometry(1920, 150, 150, 4).warps
    whole = ck.frame_chamfer_kernel(preds, gts)
    for i, j in ((0, 0), (31, 17), (63, 29)):
        alone = ck.frame_chamfer_kernel(preds[i:i + 1, j:j + 1], gts[i:i + 1, j:j + 1])
        torch.cuda.synchronize()
        assert torch.equal(alone[0, 0], whole[i, j]), (i, j)


@pytest.mark.gpu
def test_chamfer_kernel_five_channels():
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(13), 3, 5, 37, 53, c=5)
    got = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    _check_chamfer(got, preds, gts)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 6, 8, 12], ids=["c1", "c3", "c6", "c8", "c12"])
def test_chamfer_kernel_any_channels(c):
    """C < 4 padded to 4, 6 padded to 8 and 8 take the tiled kernel; 12 the
    run-time-C kernel: each a counted launch, against the plain version and
    the f64 oracle."""
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(19 + c), 3, 5, 37, 53, c=c)
    before = ck.seq_chamfer_kernel.launches
    got = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    assert ck.seq_chamfer_kernel.launches == before + 1
    _check_chamfer(got, preds, gts)


@pytest.mark.gpu
def test_chamfer_padding_keeps_the_bits():
    """Three channels padded to 4 give the bits of the same clouds with an
    explicit zero fourth channel, and twelve through the run-time-C kernel
    give the bits of the tiled C = 8 kernel where channels 8-11 are zero."""
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(20), 4, 30, 150, 150, c=3)
    zero = torch.zeros_like(preds[..., :1]), torch.zeros_like(gts[..., :1])
    got = ck.frame_chamfer_kernel(preds, gts)
    want = ck.frame_chamfer_kernel(torch.cat([preds, zero[0]], -1).contiguous(),
                                   torch.cat([gts, zero[1]], -1).contiguous())
    p8, g8 = _clouds(np.random.default_rng(21), 4, 30, 150, 150, c=8)
    tiled = ck.frame_chamfer_kernel(p8, g8)
    wide = ck.frame_chamfer_kernel(torch.cat([p8, torch.zeros_like(p8[..., :4])], -1),
                                   torch.cat([g8, torch.zeros_like(g8[..., :4])], -1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(wide, tiled)


@pytest.mark.gpu
def test_chamfer_gradients_on_the_card():
    """The kernel's forward with the plain argmin backward, on the card,
    against the same Function on the CPU."""
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(11), 2, 3, 37, 53, device="cpu")
    w = torch.linspace(0.5, 2.0, 2)
    grads = []
    for device in ("cuda", "cpu"):
        p = preds.to(device).requires_grad_()
        g = gts.to(device).requires_grad_()
        (w.to(device) * ck.seq_chamfer_kernel(p, g, avg_out=False)).sum().backward()
        grads.append((p.grad.cpu(), g.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_chamfer_raises_instead_of_falling_back():
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(12), 2, 3, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        ck.seq_chamfer_kernel(preds.double(), gts.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.seq_chamfer_kernel(preds.transpose(1, 2), gts.transpose(1, 2))
    with pytest.raises(ValueError, match="is on cpu"):
        ck.seq_chamfer_kernel(preds, gts.cpu())


# --- the custom ops and the serving artifact ------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["pointnet", "chamfer"])
def test_op_equals_its_wrapper_on_the_card(which):
    """Each custom op launches its kernel once through the wrapper, with
    the wrapper's bits."""
    _needs_card()
    rng = np.random.default_rng(20)
    if which == "pointnet":
        x = torch.from_numpy(rng.normal(size=(3, 5, 37, 4)).astype(np.float32)).cuda()
        folded = _folded(rng, 4, 64, "cuda")
        want = pn.pointnet_pool_infer(x, folded)
        before = pn.pointnet_pool_infer.launches
        got = torch.ops.osgr_torch.pointnet_pool_infer(x, [folded[k] for k in pn.FOLDED_KEYS])
        launches = pn.pointnet_pool_infer.launches - before
    else:
        preds, gts = _clouds(rng, 3, 5, 37, 41)
        want = ck.seq_chamfer_kernel(preds, gts, avg_out=False)
        before = ck.seq_chamfer_kernel.launches
        got = torch.ops.osgr_torch.seq_chamfer(preds, gts)
        launches = ck.seq_chamfer_kernel.launches - before
    torch.cuda.synchronize()
    assert launches == 1 and got.is_cuda and torch.equal(got, want)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """A V4 and an ORCED run folder from seeded port inits over the splits
    of a 5-subject synthetic raw set (NMAX 24, NSTEPS 8) → (models, gen)."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config
    from opensetgaitrecognition_pcaa_tpu_torch.convert import decoder_variables, encoder_variables
    from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
    from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import (
        generate_synthetic_raw_dataset,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path, save_params

    _needs_card()
    root = tmp_path_factory.mktemp("gpu_serving")
    raw, gen, models = str(root / "raw"), str(root / "gen"), str(root / "models")
    generate_synthetic_raw_dataset(raw, n_subjects=5, tracks_per_scenario=10,
                                   frames_per_track=(40, 56), seed=7)
    generate_splits(data_path=raw, gen_data_path=gen, train_classes=[0, 1, 2], seed=0,
                    nmax_points=24, nsteps=8, crop_step=4, n_subjects=5, verbose=False)
    dims = dict(POINTNET_OUT_DIM=32, DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=8)
    cfg = Config(GEN_DATA_PATH=gen, MODELS_PATH=models, TRAIN_CLASSES=(0, 1, 2), NMAX=24,
                 NSTEPS=8, CROP_STEP=4, **dims)
    enc_dims = dict(in_features=4, sup_latent_dim=8, pointnet_out_dim=32,
                    dtc_filters=dims["DTC_FILTERS"])
    gen_torch = torch.Generator().manual_seed(3)
    for name, encoder in (
        ("GPU_V4.3.1", CGEncoder(3, use_projection_head=True, generator=gen_torch, **enc_dims)),
        ("ORCED_GPU.3.1", ORCEDEncoder(3, generator=gen_torch, **enc_dims)),
    ):
        run_dir = f"{models}/{name}"
        cfg.replace(MODEL_NAME=name).save(f"{run_dir}/config.json")
        save_params(encoder_variables(encoder.state_dict()), module_path(run_dir, name, "E"))
    means = np.random.default_rng(3).normal(0, 0.3, (3, 8)).astype(np.float32)
    np.save(f"{models}/GPU_V4.3.1/discriminator_means.npy", means)
    decoder = ORCEDDecoder(8, 8, 24, 4, generator=gen_torch)
    save_params(decoder_variables(decoder.state_dict()),
                module_path(f"{models}/ORCED_GPU.3.1", "ORCED_GPU.3.1", "G"))
    return models, gen


@pytest.mark.gpu
def test_pcaa_artifact_exported_on_the_card(tiny_runs):
    """Exported on the card, the artifact decides as the in-process
    function does there, one kernel launch a request; loaded on the CPU it
    decides as the in-process function does on the CPU."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer import serving
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference_setup

    models, gen = tiny_runs
    path, meta = serving.export_pcaa_decision("GPU_V4.3.1", 2, models_path=models,
                                              generate_dataset=False, device="cuda")
    x, _ = RadarCropDataset(SPLIT.TEST, gen, sequential=True).load_all()
    windows = x[:10].reshape((5, 2) + x.shape[1:])
    for device in ("cuda", "cpu"):
        art = serving.load_serving_artifact(path, device=device)
        _, encoder, means = pcaa_inference_setup("GPU_V4.3.1", VARIATION.V4, device=device,
                                                 models_path=models, generate_dataset=False)
        decide = serving.make_pcaa_decision_fn(encoder, meta["n_labels"], 2)
        want = [t.cpu().numpy() for t in decide(means, meta["log_threshold"],
                                                torch.from_numpy(windows).to(device))]
        before = pn.pointnet_pool_infer.launches
        got = art.decide(windows)
        assert pn.pointnet_pool_infer.launches - before == (device == "cuda")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_orced_artifact_exported_on_the_card(tiny_runs):
    """The ORCED artifact launches the PointNet and Chamfer kernels once a
    call on the card, with the in-process forward's bits."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer import serving
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import orced_inference_setup

    models, gen = tiny_runs
    path, _ = serving.export_orced_decision("ORCED_GPU.3.1", models_path=models,
                                            generate_dataset=False, batch_size=16,
                                            device="cuda")
    art = serving.load_serving_artifact(path, device="cuda")
    _, encoder, decoder = orced_inference_setup("ORCED_GPU.3.1", device="cuda",
                                                models_path=models, generate_dataset=False)
    x = RadarCropDataset(SPLIT.TEST, gen).load_all()[0][:6]
    eps = np.random.default_rng(4).standard_normal((6, 8)).astype(np.float32)
    want = serving.make_orced_forward_fn(encoder, decoder)(
        torch.from_numpy(x).cuda(), torch.from_numpy(eps).cuda())
    before = (pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches)
    got = art.call(x, eps)
    torch.cuda.synchronize()
    assert (pn.pointnet_pool_infer.launches - before[0],
            ck.seq_chamfer_kernel.launches - before[1]) == (1, 1)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


# --- the bf16 dense route and the weight cache on the card ---------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cached", [False, True], ids=["master", "copy"])
def test_bf16_dense_on_the_card_matches_the_cpu_route(cached):
    """``models/layers.py::dense`` at bf16 on the card (``Bf16Dense``:
    cuBLAS's bf16 GEMMs, f32 accumulation) against the CPU route: y and the
    three gradients within a bf16 rounding step of their scale (f32 sums in
    other orders before the rounding)."""
    from opensetgaitrecognition_pcaa_tpu_torch.models.layers import dense

    _needs_card()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 576, generator=g).to(BF16)
    w = torch.randn(1152, 576, generator=g) / 24
    b = torch.randn(1152, generator=g) / 24
    cot = torch.randn(16, 1152, generator=g).to(BF16)
    outs = []
    for device in ("cuda", "cpu"):
        xx, ww, bb = (t.to(device).requires_grad_() for t in (x, w, b))
        w16 = ww.detach().to(BF16).requires_grad_() if cached else None
        y = dense(xx, ww, bb, BF16, w16)
        y.backward(cot.to(device))
        outs.append([t.detach().float().cpu() for t in
                     (y, xx.grad, (w16 if cached else ww).grad, bb.grad)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=0, atol=2.0**-7 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("nu16", [False, True], ids=["bf16", "bf16_nu16"])
def test_weight_cache_changes_no_bit_on_the_card(nu16):
    """The V4 step at bf16 with the kernels on, 3 steps with
    ``BF16_WEIGHT_CACHE`` and 3 without from one seeded state, cuDNN
    deterministic: every parameter and moment bitwise equal; the Adam
    kernel wrote the copy once a step."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    _needs_card()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(8, 12, 64, 4)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.arange(8) % 3).cuda()
    noise = [(torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).cuda(),
              torch.from_numpy(rng.uniform(size=(8, 1)).astype(np.float32)).cuda())
             for _ in range(3)]
    counter = "launches_mv16_w16" if nu16 else "launches_m16_w16"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for cache in (False, True):
            cfg = Config(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=nu16, BF16_WEIGHT_CACHE=cache,
                         FUSED_POINTNET=True, FUSED_ADAM=True, **VARIANT_DIMS)
            mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
            step = make_train_step(mods, cfg)
            before = getattr(adam.adam_update_, counter)
            for i in range(3):
                step(state, x, y, i, noise[i])
            torch.cuda.synchronize()
            assert getattr(adam.adam_update_, counter) - before == (3 if cache else 0)
            states.append({**mods.state_dict(),
                           **{f"mu.{k}": v for k, v in state.opt_g.mu.items()},
                           **{f"nu.{k}": v for k, v in state.opt_g.nu.items()}})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
