"""Farthest-point sampling and the ball query (``ops/p4t_group.py``, CPU
path: the plain versions the CUDA kernels are held to bit for bit) against a
numpy transcription of pointnet2's loops and against the loop reference
``tests/p4t_reference.py``: equal indices on random frames, on frames padded
by repeated points, on ties, on balls with fewer than K points and on empty
balls."""

import numpy as np
import pytest
import torch

import p4t_reference as ref
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_group import (
    ball_query,
    furthest_point_sample,
    radius_sq,
)

torch.set_num_threads(1)


def np_fps(points: np.ndarray, m: int) -> list:
    """pointnet2's ``furthest_point_sampling_kernel`` for one frame, in f32,
    with the lowest index winning a tie."""
    n = points.shape[0]
    temp = np.full(n, np.inf, np.float32)
    idxs, old = [0], 0
    for _ in range(1, m):
        best, besti = np.float32(-1), 0
        for k in range(n):
            d = points[k, :3] - points[old, :3]
            d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
            temp[k] = min(d2, temp[k])
            if temp[k] > best:
                best, besti = temp[k], k
        old = besti
        idxs.append(old)
    return idxs


def np_ball(points: np.ndarray, anchor: np.ndarray, r2: np.float32, k_max: int) -> list:
    """pointnet2's ``query_ball_point_kernel`` for one anchor."""
    idx = [0] * k_max
    cnt = 0
    for k in range(points.shape[0]):
        if cnt >= k_max:
            break
        d = points[k, :3] - anchor[:3]
        if (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] < r2:
            if cnt == 0:
                idx = [k] * k_max
            idx[cnt] = k
            cnt += 1
    return idx


def crops(kind: str, seed: int, b=2, t=6, n=24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, t, n, 4)).astype(np.float32)
    if kind == "repeated":  # few real points, padded by repeating them, as the traffic does
        real = 5
        x[:, :, real:] = x[:, :, rng.integers(0, real, n - real)]
    elif kind == "ties":  # a lattice: many equal distances
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
        x[..., :3] = 0.25 * grid[rng.permutation(27)[:n]]
    elif kind == "sparse":  # wide frames: balls with fewer than K points, and empty ones
        x[..., :3] *= 4.0
        x[:, 1::2, :, 0] += 5.0
    return x


KINDS = ["random", "repeated", "ties", "sparse"]


@pytest.mark.parametrize("kind", KINDS)
def test_fps_equals_pointnet2_loops(kind):
    x = crops(kind, 1)
    got = furthest_point_sample(torch.from_numpy(x), 12)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            want = np_fps(x[b, t], 12)
            assert got[b, t].tolist() == want, (b, t)
            assert ref.fps(torch.from_numpy(x[b, t]), 12) == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [8, 32])
def test_ball_query_equals_pointnet2_loops(kind, k):
    x = crops(kind, 2)
    radius = 0.7
    r2 = np.float32(radius_sq(radius))
    frames = torch.from_numpy(x[:, 0::2])
    anchor = furthest_point_sample(frames, 6)                      # (B, 3, 6)
    got = ball_query(torch.from_numpy(x), anchor, radius, k)       # (B, 3, 6, 3, K)
    fills = []
    for b in range(x.shape[0]):
        for l in range(3):
            for m in range(6):
                a = x[b, 2 * l, int(anchor[b, l, m])]
                for s in range(3):
                    frame = x[b, min(max(2 * l + s - 1, 0), x.shape[1] - 1)]
                    want = np_ball(frame, a, r2, k)
                    assert got[b, l, m, s].tolist() == want, (b, l, m, s)
                    assert ref.ball(torch.from_numpy(frame), torch.from_numpy(a), r2, k) == want
                    fills.append(int((ref.sq_dist(torch.from_numpy(frame),
                                                  torch.from_numpy(a)) < float(r2)).sum()))
    if kind == "sparse":  # the cases this kind is for
        assert min(fills) == 0 and any(0 < f < k for f in fills)
    if kind == "repeated":
        assert max(fills) >= 8


def test_group_refuses_bad_shapes():
    x = torch.zeros(1, 6, 24, 4)
    with pytest.raises(ValueError, match="anchors"):
        furthest_point_sample(x, 25)
    with pytest.raises(ValueError, match="do not fit"):
        ball_query(x, torch.zeros(1, 4, 6, dtype=torch.int64), 0.7, 8)
