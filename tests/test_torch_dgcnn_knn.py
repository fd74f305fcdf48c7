"""The kNN graph of DGCNN's EdgeConv layers (``ops/dgcnn_knn.py``, CPU path:
the plain version the CUDA kernel is held to bit for bit) against a loop over
each point's candidates in numpy float32, each difference, product and sum
rounded on its own, sorted by (distance, index); and against the benchmark
reference's own kNN (``benchmark/reference/pcaa_v4_dgcnn.py``), which the
cell's ``graph_gap`` reads. Ties (duplicated points), fewer points than k
and f64 features included."""

import numpy as np
import pytest
import torch

from benchmark.reference import pcaa_v4_dgcnn as ref
from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_knn import all_sq_dists, dgcnn_knn

torch.set_num_threads(1)


def loop_knn(h: np.ndarray, k: int) -> np.ndarray:
    """Each point's ``min(k, N)`` nearest, by a loop over its candidates in
    the contract's arithmetic."""
    f, n, c = h.shape
    out = np.zeros((f, n, min(k, n)), np.int64)
    for fi in range(f):
        for i in range(n):
            keys = []
            for j in range(n):
                d = np.float32(0.0)
                for ch in range(c):
                    diff = np.float32(h[fi, i, ch] - h[fi, j, ch])
                    d = np.float32(d + np.float32(diff * diff))
                keys.append((d, j))
            out[fi, i] = [j for _, j in sorted(keys)[:min(k, n)]]
    return out


def features(seed, f=3, n=24, c=5, dup=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (f, n, c)).astype(np.float32)
    if dup:
        h[:, n - dup:] = h[:, :dup]  # frames padded by repeated points: exact ties
    return h


@pytest.mark.parametrize("seed,c,dup", [(0, 4, 0), (1, 5, 8), (2, 16, 12)])
def test_indices_against_a_loop(seed, c, dup):
    h = features(seed, c=c, dup=dup)
    got = dgcnn_knn(torch.from_numpy(h), 5)
    assert got.dtype == torch.int64 and got.shape == (3, 24, 5)
    np.testing.assert_array_equal(got.numpy(), loop_knn(h, 5))
    if dup:  # a repeated point is its own nearest, its copy the next
        assert torch.equal(got[:, :dup, :2].sort(dim=-1).values,
                           torch.stack([torch.arange(dup), torch.arange(24 - dup, 24)], -1)
                           .expand(3, -1, -1))


def test_fewer_points_than_k_give_a_complete_graph():
    h = features(3, n=4)
    got = dgcnn_knn(torch.from_numpy(h), 20)
    assert got.shape == (3, 4, 4)
    assert torch.equal(got.sort(dim=-1).values, torch.arange(4).expand(3, 4, 4))
    np.testing.assert_array_equal(got.numpy(), loop_knn(h, 20))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_benchmark_reference_builds_the_same_graph(dtype):
    h = torch.from_numpy(features(4, c=8, dup=6)).to(dtype)
    idx, kth = ref.knn(h, 5)
    assert torch.equal(dgcnn_knn(h, 5), idx)
    d = all_sq_dists(h)
    assert torch.equal(kth, d.sort(dim=-1).values[..., 4])
    assert torch.equal(ref.sq_dists(h, idx), torch.gather(d, 2, idx))
    assert torch.equal(ref.all_sq_dists(h), d)


def test_point_itself_is_nearest_without_ties():
    h = torch.from_numpy(features(5))
    assert torch.equal(dgcnn_knn(h, 3)[..., 0], torch.arange(24).expand(3, 24))


@pytest.mark.parametrize("shape,k", [((24, 4), 5), ((3, 0, 4), 5), ((3, 24, 4), 0)])
def test_refuses(shape, k):
    with pytest.raises(ValueError):
        dgcnn_knn(torch.zeros(shape), k)
