"""Host-side raw-track preprocessing: ragged radar frames → fixed-shape
crops.

Port of ``opensetgaitrecognition_pcaa_tpu/data/preprocess.py:34-144``,
numpy and pickle only, line for line: the generator draws come in the same
order, so a track gives the JAX package's crops bit for bit. Layout is
channels-last ``(T, N, C)``. Kept quirks of the reference pipeline:

- forced point subsampling picks a permutation of the *first* ``force``
  points, not a random subset of all points;
- the dB power is concatenated and then cut away when ``NFEATURES=4``;
- padding repeats randomly chosen points *with* replacement, appended
  after the original points;
- per-cloud standardization subtracts the mean only.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np


def crop_with_step(sequence: np.ndarray, crop_len: int, step: int) -> np.ndarray:
    """Overlapping sliding windows over the leading axis.

    Returns ``(n_crops, crop_len, ...)`` with
    ``n_crops = ceil((len(sequence) - crop_len) / step)`` — the reference's
    exact (exclusive-end) window count (``datasets.py:16-25``): a sequence of
    exactly ``crop_len`` frames yields zero crops.
    """
    n = len(sequence)
    starts = np.arange(n - crop_len, step=step)
    if len(starts) == 0:
        return np.empty((0, crop_len) + sequence.shape[1:], dtype=sequence.dtype)
    # Gather-based windowing (no python loop over windows).
    idx = starts[:, None] + np.arange(crop_len)[None, :]
    return sequence[idx]


def process_frames(
    frames: Sequence[dict],
    *,
    nmax: int,
    nfeatures: int = 4,
    standardize_point_cloud: bool = True,
    divide_by_std: bool = False,
    force_pc_subsampling: int = 0,
    rng: Optional[np.random.Generator] = None,
    force_rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Convert a list of ragged frame dicts into a ``(T, nmax, nfeatures)`` array.

    Each frame dict carries ``cardinality``, ``elements`` (xy), ``z_coord``,
    ``dopplers``, ``powers`` (reference schema, ``datasets.py:100-104``).

    ``rng`` drives pad/subsample choices (the reference uses the unseeded
    global ``np.random`` there — ``datasets.py:131,137`` — so bitwise parity
    is impossible by construction; we thread an explicit generator).
    ``force_rng`` drives forced subsampling (the reference re-seeds a local
    generator with 0 per track — ``datasets.py:91``).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    if force_rng is None:
        force_rng = np.random.default_rng(0)

    out = np.empty((len(frames), nmax, nfeatures), dtype=np.float32)

    for t, frame in enumerate(frames):
        cardinality = int(np.asarray(frame["cardinality"]).reshape(-1)[0])
        elements = np.asarray(frame["elements"], dtype=np.float64)
        zs = np.asarray(frame["z_coord"], dtype=np.float64).reshape(-1, 1)
        dopplers = np.asarray(frame["dopplers"], dtype=np.float64).reshape(-1, 1)
        powers = np.asarray(frame["powers"], dtype=np.float64).reshape(-1, 1)

        if 0 < force_pc_subsampling < cardinality:
            # Quirk preserved: indices are drawn from range(force), i.e. a
            # permutation of the first `force` points (datasets.py:108-116).
            cardinality = force_pc_subsampling
            choices = force_rng.choice(
                cardinality, force_pc_subsampling, replace=False
            )
            elements = elements[choices]
            zs = zs[choices]
            dopplers = dopplers[choices]
            powers = powers[choices]

        powers_db = 10.0 * np.log10(powers + 1e-8)
        feats = np.concatenate([elements, zs, dopplers, powers_db], axis=1)[
            :, :nfeatures
        ]

        if cardinality < nmax:
            # Pad by repeating random points (with replacement), appended
            # after the originals (datasets.py:127-134).
            pad_idx = rng.choice(cardinality, nmax - cardinality)
            cloud = np.concatenate([feats, feats[pad_idx]], axis=0)
        else:
            keep = rng.choice(cardinality, nmax, replace=False)
            cloud = feats[keep]

        if standardize_point_cloud:
            cloud = cloud - cloud.mean(axis=0)
            if divide_by_std:
                cloud = cloud / (cloud.std(axis=0) + 1e-8)

        out[t] = cloud.astype(np.float32)

    return out


def process_track(
    track_file_path: str,
    *,
    nmax: int,
    nfeatures: int = 4,
    standardize_point_cloud: bool = True,
    divide_by_std: bool = False,
    force_pc_subsampling: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Load a pickled raw track and preprocess it (reference ``datasets.py:79-161``)."""
    with open(track_file_path, "rb") as f:
        frames = pickle.load(f)
    return process_frames(
        frames,
        nmax=nmax,
        nfeatures=nfeatures,
        standardize_point_cloud=standardize_point_cloud,
        divide_by_std=divide_by_std,
        force_pc_subsampling=force_pc_subsampling,
        rng=rng,
    )
