"""Crop-file dataset: a split directory → one ``(n, T, N, C)`` f32 array,
and the batch order of a training epoch.

Port of ``opensetgaitrecognition_pcaa_tpu/data/dataset.py:26-177``, numpy
only (the JAX package's ``data`` package imports sklearn and jax). The
filename contract, the crop order and the subject-id → label remap are the
JAX package's, line for line: the remap replays CPython's set-iteration
order, which decides which unseen subject is held out for threshold
validation.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO, SPLIT

_FNAME_RE = re.compile(r"crop(\d+)_subj(\d+)_(.+)_track(.+)\.npy")


def parse_crop_filename(fname: str) -> Tuple[int, int, str, str]:
    """→ (crop_index, subject, scenario, track_id).

    Filename contract: ``crop{i}_subj{j}_{scenario}_track{t}.npy``.
    """
    m = _FNAME_RE.fullmatch(fname)
    if not m:
        raise ValueError(f"bad crop filename: {fname}")
    return int(m.group(1)), int(m.group(2)), m.group(3), m.group(4)


class RadarCropDataset:
    """All crops of one split as host numpy arrays."""

    def __init__(
        self,
        split: SPLIT,
        gen_data_path: str,
        scenarios: Sequence[SCENARIO] = tuple(SCENARIO),
        sequential: bool = False,
        subsample_factor: float = 1.0,
        subsample_rng: Optional[np.random.Generator] = None,
    ):
        self.split = split
        self.dataset_dir = os.path.join(gen_data_path, split.value)
        self.sequential = sequential

        # The raw (unsorted) listing drives the label remap below; the data
        # order itself is sorted for determinism.
        raw = [(f, parse_crop_filename(f)) for f in os.listdir(self.dataset_dir)]
        scen_values = {s.value for s in scenarios}
        parsed = sorted((fp for fp in raw if fp[1][2] in scen_values))

        if sequential:
            # (subject, scenario, track, crop index): consecutive items are
            # consecutive time windows of one walk
            parsed.sort(key=lambda p: (p[1][1], p[1][2], p[1][3], p[1][0]))

        if subsample_factor < 1.0:
            rng = subsample_rng or np.random.default_rng(0)
            keep = rng.choice(
                len(parsed), int(len(parsed) * subsample_factor), replace=False
            )
            if sequential:
                keep = np.sort(keep)
            parsed = [parsed[i] for i in keep]

        self.filenames: List[str] = [f for f, _ in parsed]
        self.original_labels = np.array([p[1] for _, p in parsed], dtype=np.int32)
        self.tracks = [p[3] for _, p in parsed]

        # Subject ids → contiguous labels in the reference's set-iteration
        # order (first encounter over the raw listing; see the JAX
        # package's data/dataset.py for the two modes). Do not "simplify"
        # to a sorted remap: it changes which subject is held out.
        kept = {f for f, _ in parsed}
        kept_subjects = {p[1] for f, p in raw if f in kept}
        if sequential:
            encounter = (p[1] for _, p in raw)
        else:
            encounter = (p[1] for f, p in raw if f in kept)
        classes = list({s for s in encounter if s in kept_subjects})
        self.class_map = {c: i for i, c in enumerate(classes)}
        self.labels = np.array(
            [self.class_map[c] for c in self.original_labels], dtype=np.int32
        )
        self.n_classes = len(classes)

        self._arrays: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.filenames)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """→ (``(n, T, N, C)`` float32, ``(n,)`` int32). Cached after first call."""
        if self._arrays is None:
            if not self.filenames:
                raise ValueError(f"empty split dir: {self.dataset_dir}")
            first = np.load(os.path.join(self.dataset_dir, self.filenames[0]))
            out = np.empty((len(self.filenames),) + first.shape, dtype=np.float32)
            out[0] = first
            for i, f in enumerate(self.filenames[1:], start=1):
                out[i] = np.load(os.path.join(self.dataset_dir, f))
            self._arrays = out
        return self._arrays, self.labels


def epoch_batch_indices(
    n: int,
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
) -> np.ndarray:
    """Index matrix ``(steps, batch_size)`` for one epoch over ``n`` samples.

    The JAX package's function line for line, so the same numpy
    ``Generator`` stream gives the same batches: ``rng.shuffle`` over
    ``arange(n)``, then the last partial batch dropped (every reference
    training loader drops it) or padded from the start of the order.
    """
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng(0)).shuffle(order)
    steps = n // batch_size if drop_last else -(-n // batch_size)
    if not drop_last and steps * batch_size > n:
        pad = steps * batch_size - n
        order = np.concatenate([order, order[:pad]])
    return order[: steps * batch_size].reshape(steps, batch_size)
