"""Fixed class-centroid sampling on a hypersphere.

Copy of ``opensetgaitrecognition_pcaa_tpu/ops/centroids.py`` (numpy only;
the JAX package's ``ops`` package imports jax, so the port cannot import
it from there). 10k standard-normal points are normalized onto a sphere of
radius ``sphere_radius``, and ``n`` of them are picked by farthest-point
sampling, retried until the minimum pairwise distance reaches
``min_dist``. Training calls it once per run with seed 42, so the same
arguments give the JAX package's centroids bit for bit.
"""

from __future__ import annotations

import numpy as np


def _farthest_point_sampling(
    points: np.ndarray, n_samples: int, rng: np.random.Generator
) -> list:
    n_points = points.shape[0]
    distances = np.full(n_points, 1e10)
    farthest = int(rng.integers(low=0, high=n_points))
    sampled = [farthest]
    for _ in range(n_samples - 1):
        dist = np.sum((points - points[farthest]) ** 2, axis=1)
        distances = np.minimum(distances, dist)
        farthest = int(np.argmax(distances))
        sampled.append(farthest)
    return sampled


def sample_distant_points(
    dimension: int,
    n: int,
    min_dist: float,
    sphere_radius: float,
    seed: int = 42,
) -> np.ndarray:
    """``n`` well-separated centroids on a ``dimension``-D sphere:
    ``(n, dimension)`` float32, pairwise distances ≥ ``min_dist``."""
    rng = np.random.default_rng(seed)

    npoints = 10000
    vec = rng.standard_normal(size=(dimension, npoints))
    vec = vec / np.linalg.norm(vec, axis=0) * sphere_radius

    while True:
        idxs = _farthest_point_sampling(vec.T, n, rng)
        sampled = vec[:, idxs].T  # (n, dimension)
        diff = sampled[:, None, :] - sampled[None, :, :]
        dist = np.sqrt((diff**2).sum(-1))
        positive = dist[dist > 0]
        if positive.size == 0 or positive.min() >= min_dist:
            break
    return sampled.astype(np.float32)
