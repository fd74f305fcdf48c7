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


def _folded(rng, c: int, d: int, device: str = "cpu"):
    h = d // 2
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
    "shape,d",
    [((2, 3, 150, 4), 1024), ((1, 97, 37, 4), 1024), ((3, 5, 33, 4), 512),
     ((2, 3, 1, 4), 1024), ((4, 5, 16, 4), 1024), ((3, 7, 150, 4), 512), ((2, 3, 150, 5), 1024)],
    ids=["n150", "ragged_f97_n37", "d512", "n1", "n16_no_padding", "d512_n150", "c5"],
)
def test_kernel_matches_plain(shape, d):
    _needs_card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    folded = _folded(rng, shape[-1], d, "cuda")
    before = pn.pointnet_pool_infer.launches
    got = pn.pointnet_pool_infer(x, folded)
    torch.cuda.synchronize()
    assert pn.pointnet_pool_infer.launches == before + 1
    # same bound as bench.py's kernel-parity check
    torch.testing.assert_close(got, pn.pointnet_pool_ref(x, folded), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernel_rows_do_not_depend_on_the_batch(monkeypatch):
    """A frame's pooled row is the same bits alone, in a larger batch and
    when the batch is walked in several passes."""
    _needs_card()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(24, 30, 150, 4)).astype(np.float32)).cuda()
    folded = _folded(rng, 4, 1024, "cuda")
    whole = pn.pointnet_pool_infer(x, folded)
    alone = torch.cat([pn.pointnet_pool_infer(x[i:i + 1, 3:11], folded) for i in (0, 5, 23)])
    monkeypatch.setattr(pn, "_PASS_ROWS", 7 * 160)  # 7 frames a pass: 103 passes
    passes = pn.pointnet_pool_infer(x, folded)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[[0, 5, 23], 3:11])
    assert torch.equal(passes, whole)


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
    x, folded = _cpu_case(d, c)
    with pytest.raises(ValueError):
        pn._check_cuda_args(x, folded)


@pytest.mark.parametrize("c", [5, 300], ids=["c5", "c300"])
def test_argument_checks_accept_any_channel_count(c):
    """The kernel pads the channels to a multiple of 4; it has no C limit."""
    x, folded = _cpu_case(1024, c)
    assert pn._check_cuda_args(x, folded) == 1024


def test_argument_checks_accept_main_path_shapes():
    x, folded = _cpu_case()
    assert pn._check_cuda_args(x, folded) == 1024


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
     (6, 4, 512, False), (6, 512, 1024, True), (300, 36, 132, True), (72000, 4, 512, False)],
    ids=["ragged_2x3x37_k4", "ragged_cols", "w512", "w1024", "n1_k4", "n1_w1024",
         "ragged_k36_n132", "train_rows_k4"],
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
def test_pointnet_train_gradients_on_the_card():
    """The autograd Function through the kernels against autograd through
    the plain version, on the card (tolerances as in the CPU test)."""
    _needs_card()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 37, 4)).astype(np.float32)
    widths = [(4, 8), (8, 8), (8, 16), (16, 16)]
    layers = [((rng.uniform(-1, 1, (a, c)) / np.sqrt(a)).astype(np.float32),
               rng.uniform(-0.1, 0.1, c).astype(np.float32),
               (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
               (0.1 * rng.normal(size=c)).astype(np.float32)) for a, c in widths]
    cot = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32)).cuda()
    grads = []
    for fn in (pt.pointnet_pool_train, pt.pointnet_pool_train_ref):
        params = [[torch.tensor(a, device="cuda", requires_grad=True) for a in layer]
                  for layer in layers]
        xt = torch.tensor(x, device="cuda", requires_grad=True)
        pooled, means, variances = fn(xt, params)
        torch.sum(pooled * cot).backward()
        grads.append([pooled, *means, *variances, xt.grad]
                     + [p.grad for i, layer in enumerate(params) for p in layer])
    names = ["pooled"] + [f"stat{i}" for i in range(8)] + ["x"] + [
        f"{n}{i}" for i in range(4) for n in ("W", "b", "gamma", "beta")]
    for name, got, want in zip(names, *grads):
        # the bias ahead of a train-mode BatchNorm has a zero gradient: noise only
        tol = dict(rtol=0, atol=5e-6) if name.startswith("b") and name[1:].isdigit() else \
            dict(rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.detach(), want.detach(), msg=name, **tol)


@pytest.mark.gpu
def test_pointnet_train_raises_instead_of_falling_back():
    _needs_card()
    h, affine, w, b = _layer_case(np.random.default_rng(6), 64, 6, 8, True)
    with pytest.raises(ValueError, match="multiples of 4"):
        pt.fused_layer(h, affine, w, b)
    h, affine, w, b = _layer_case(np.random.default_rng(6), 64, 8, 8, True)
    with pytest.raises(ValueError, match="is on cpu"):
        pt.fused_layer(h, affine, w.cpu(), b)


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
     (4, 6, 704, 704)],
    ids=["n150", "ragged_n37_m53", "n1", "n1_m9", "two_tiles", "n704"],
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
def test_chamfer_kernel_five_channels():
    _needs_card()
    preds, gts = _clouds(np.random.default_rng(13), 3, 5, 37, 53, c=5)
    got = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    _check_chamfer(got, preds, gts)


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
