"""The DGCNN kernels (``csrc/dgcnn_knn.cu``, ``csrc/dgcnn_edge.cu``) against
their plain PyTorch versions on the card, at the cell's shapes (480 frames of
150 points, k 20, the layers' widths) on the benchmark's synthetic crops and
on random features:

- the kNN graph: the indices bit for bit (each difference, product and sum
  rounded on its own on both sides), also at ragged sizes, with duplicate
  points and with fewer points than k;
- the edge pass's forward: the extremum and its slot bit for bit (the same
  additions and comparisons), the statistics and the output within f32
  rounding of sums over 1,440,000 edges taken in other orders; eval mode;
- its backward: ``d_ab``, ``dγ`` and ``dβ`` within f32 rounding of the plain
  version's sums (whose ``index_add_`` is in no fixed order);
- repeatability: every output bitwise equal across launches.

The tests need a CUDA card and skip themselves elsewhere. This file imports
no JAX, so that on the card it runs alone:
``python -m pytest --noconftest -m gpu tests/test_torch_dgcnn_gpu.py``.
"""

import pytest
import torch

from benchmark import traffic
from opensetgaitrecognition_pcaa_tpu_torch.ops import dgcnn_edge, dgcnn_knn

MIX = {"crops": 16, "classes": 6, "frames": [60, 100], "points": [40, 220]}
DIMS = {"NMAX": 150, "NSTEPS": 30, "CROP_STEP": 6}
WIDTHS = (64, 64, 128, 256)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _frames(seed: int, device) -> torch.Tensor:
    x = torch.from_numpy(traffic.crops(MIX, DIMS, seed)[0]).to(device)
    return x.reshape(-1, 150, 4).contiguous()


def _features(seed: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_knn_bitwise_on_crops_and_features(seed):
    dev = _card()
    dgcnn_knn.dgcnn_knn.launches = 0
    for h in (_frames(seed, dev), _features(seed, (480, 150, 64), dev),
              _features(seed + 1, (480, 150, 128), dev)):
        got = dgcnn_knn.dgcnn_knn(h, 20)
        assert torch.equal(got, dgcnn_knn.knn_ref(h, 20))
    assert dgcnn_knn.dgcnn_knn.launches == 3


@pytest.mark.gpu
def test_knn_ragged_ties_and_few_points():
    """N not a multiple of 32, N = 256 at 128 channels, duplicated points
    (exact ties: the lower index first), and N < k (a complete graph)."""
    dev = _card()
    dup = _features(7, (8, 40, 4), dev)
    dup = torch.cat([dup, dup[:, :30]], dim=1).contiguous()
    for h, k in ((_features(3, (5, 37, 5), dev), 5), (_features(4, (3, 256, 128), dev), 20),
                 (dup, 20), (_features(5, (6, 7, 64), dev), 20), (_features(6, (4, 1, 3), dev), 2)):
        got = dgcnn_knn.dgcnn_knn(h, k)
        assert got.shape == h.shape[:2] + (min(k, h.shape[1]),)
        assert torch.equal(got, dgcnn_knn.knn_ref(h, k))


def _edge_inputs(seed, o, dev, frames=480, n=150, k=20):
    h = _features(seed, (frames, n, 16), dev)
    idx = dgcnn_knn.dgcnn_knn(h, k)
    ab = _features(seed + 1, (frames, n, 2 * o), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    gamma = torch.rand(o, generator=gen, device=dev) * 2 - 0.5      # some negative scales
    beta = torch.rand(o, generator=gen, device=dev) * 0.2 - 0.1
    mean = torch.rand(o, generator=gen, device=dev) * 0.2 - 0.1
    var = torch.rand(o, generator=gen, device=dev) + 0.5
    return ab, idx, gamma, beta, mean, var


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("o", WIDTHS[1:])
@pytest.mark.parametrize("train", [True, False])
def test_edge_forward_against_plain(o, train):
    dev = _card()
    ab, idx, gamma, beta, mean, var = _edge_inputs(11, o, dev)
    dgcnn_edge.edge_conv.launches = 0
    y, m, v = dgcnn_edge.edge_conv(ab, idx, gamma, beta, mean, var, train)
    assert dgcnn_edge.edge_conv.launches == (3 if train else 2)
    ext, slot, pm, pv = dgcnn_edge.edge_forward_ref(ab, idx, gamma, train)
    if train:
        torch.testing.assert_close(m, pm, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(v, pv, rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(m, mean) and torch.equal(v, var)
    want = dgcnn_edge.edge_out_ref(ext, m, v, gamma, beta, 1e-5, 0.2)
    assert torch.equal(y, want)  # the same statistics give the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("o", [64, 256])
@pytest.mark.parametrize("train", [True, False])
def test_edge_backward_against_plain(o, train):
    dev = _card()
    ab, idx, gamma, beta, mean, var = _edge_inputs(13, o, dev)
    ab.requires_grad_()
    gamma.requires_grad_()
    beta.requires_grad_()
    y, m, v = dgcnn_edge.edge_conv(ab, idx, gamma, beta, mean, var, train)
    dy = _features(17, y.shape, dev)
    got = torch.autograd.grad(y, (ab, gamma, beta), dy)
    with torch.no_grad():
        ext, slot, _, _ = dgcnn_edge.edge_forward_ref(ab, idx, gamma, train)
        want = dgcnn_edge.edge_backward_ref(dy, ab, idx, ext, slot, m, v, gamma, beta, 1e-5,
                                            0.2, train)
    for name, g, w in zip(("d_ab", "dgamma", "dbeta"), got, want):
        assert _rel(g, w) < 2e-5, (name, _rel(g, w))


@pytest.mark.gpu
def test_edge_repeatable():
    dev = _card()
    ab, idx, gamma, beta, mean, var = _edge_inputs(19, 128, dev)
    ab.requires_grad_()
    dy = _features(23, (480, 150, 128), dev)
    runs = []
    for _ in range(3):
        y, m, v = dgcnn_edge.edge_conv(ab, idx, gamma, beta, mean, var, True)
        runs.append((y, m, v) + torch.autograd.grad(y, ab, dy))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    g1 = dgcnn_knn.dgcnn_knn(ab.detach()[..., :64].contiguous(), 20)
    assert torch.equal(g1, dgcnn_knn.dgcnn_knn(ab.detach()[..., :64].contiguous(), 20))


@pytest.mark.gpu
def test_edge_kernels_extremum_bitwise():
    """The forward's extremum and slot, read back through the backward's
    saved tensors, are the plain version's bits."""
    dev = _card()
    ab, idx, gamma, beta, mean, var = _edge_inputs(29, 256, dev)
    ab.requires_grad_()
    y, _, _ = dgcnn_edge.edge_conv(ab, idx, gamma, beta, mean, var, True)
    saved = y.grad_fn.saved_tensors
    ext, slot = saved[2], saved[3]
    want_ext, want_slot, _, _ = dgcnn_edge.edge_forward_ref(ab.detach(), idx, gamma, True)
    assert torch.equal(ext, want_ext) and torch.equal(slot, want_slot)
