"""Split generation: raw tracks → train/valid/test/unseen crop files.

Port of ``opensetgaitrecognition_pcaa_tpu/data/splits.py:33-177`` in numpy
alone. Per seen subject and scenario, the tracks are split 0.8/0.1/0.1 by
``train_test_split``, a numpy copy of the one sklearn call the JAX package
makes: the same permutation, sizes and errors, so the same tracks land in
each split. Every track of an unseen subject goes to ``unseen/``. Crops
are written as ``crop{i}_subj{j}_{scenario}_track{t}.npy``, the
reference's file names, so two packages' splits compare file by file.
Each split directory is wiped and rebuilt on every call.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import N_SUBJECTS, SPLIT
from opensetgaitrecognition_pcaa_tpu_torch.data.preprocess import (
    crop_with_step,
    process_track,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness


def train_test_split(items: Sequence, *, train_size: float,
                     random_state: int) -> Tuple[List, List]:
    """``sklearn.model_selection.train_test_split(items,
    train_size=train_size, random_state=random_state)`` for a float
    ``train_size``, in numpy: ``n_train = floor(train_size · n)``, the rest
    is the test part, and with ``perm = RandomState(random_state)
    .permutation(n)`` the test part is ``perm[:n_test]`` and the train part
    ``perm[n_test:n_test + n_train]``. Raises sklearn's ``ValueError`` where
    a part comes out empty."""
    n = len(items)
    if not 0 < train_size < 1:
        raise ValueError(
            f"train_size={train_size} should be either positive and smaller than the "
            f"number of samples {n} or a float in the (0, 1) range"
        )
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size=None and train_size={train_size}, the "
            "resulting train set will be empty. Adjust any of the aforementioned "
            "parameters."
        )
    if n_test <= 0:
        raise ValueError(
            f"test_size={n_test} should be either positive and smaller than the number "
            f"of samples {n} or a float in the (0, 1) range"
        )
    perm = np.random.RandomState(random_state).permutation(n)
    return ([items[i] for i in perm[n_test:n_test + n_train]],
            [items[i] for i in perm[:n_test]])


SUBJECT_DIR_FMT = "target{}"  # reference label_dict values (datasets.py:49-60)


def _track_index_from_filename(fname: str) -> str:
    """Track id = filename minus its 5-char ``pc_tr`` prefix and extension.

    Mirrors ``pc_file.split("/")[-1][5:].split(".")[0]``
    (reference ``datasets.py:305-306``).
    """
    return fname[5:].split(".")[0]


def _write_crops(
    pc_file: str,
    subj_idx: int,
    scenario: str,
    target_dir: str,
    *,
    nsteps: int,
    crop_step: int,
    nmax_points: int,
    force_pc_subsampling: int,
    rng: np.random.Generator,
) -> int:
    pcloud = process_track(
        pc_file,
        nmax=nmax_points,
        standardize_point_cloud=True,
        divide_by_std=False,
        force_pc_subsampling=force_pc_subsampling,
        rng=rng,
    )
    crops = crop_with_step(pcloud, crop_len=nsteps, step=crop_step)
    track_index = _track_index_from_filename(os.path.basename(pc_file))
    for crop_index in range(len(crops)):
        np.save(
            os.path.join(
                target_dir,
                f"crop{crop_index}_subj{subj_idx}_{scenario}_track{track_index}.npy",
            ),
            crops[crop_index],
        )
    return len(crops)


def generate_splits(
    *,
    data_path: str,
    gen_data_path: str,
    train_classes: Sequence[int] = (),
    train_ratio: float = 0.8,
    valid_ratio: float = 0.1,
    test_ratio: float = 0.1,
    seed: int = 0,
    force_pc_subsampling: int = 0,
    nmax_points: int = 150,
    nsteps: int = 30,
    crop_step: int = 6,
    n_subjects: int = N_SUBJECTS,
    verbose: bool = True,
) -> Dict[str, int]:
    """Materialize the four split directories. Returns per-split crop counts."""
    assert abs(train_ratio + valid_ratio + test_ratio - 1.0) < 1e-9

    train_classes = list(train_classes)
    unseen_classes = np.setdiff1d(np.arange(n_subjects), train_classes).tolist()
    if not train_classes:
        train_classes = list(range(n_subjects))
        unseen_classes = []

    split_dirs = {s: os.path.join(gen_data_path, s.value) for s in SPLIT}
    for d in split_dirs.values():
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))

    # pad/subsample draws: one generator seeded per call, threaded through
    # the tracks in order
    pad_rng = np.random.default_rng(seed)

    t0 = time.time()
    counts = {s.value: 0 for s in SPLIT}

    for subj_idx in train_classes:
        subject_dir = os.path.join(data_path, SUBJECT_DIR_FMT.format(subj_idx))
        for scenario in sorted(os.listdir(subject_dir)):
            scen_dir = os.path.join(subject_dir, scenario)
            all_tracks = sorted(os.listdir(scen_dir))
            assert all(t[:2] == "pc" for t in all_tracks), (
                f"Invalid file in {scen_dir}"
            )
            train_tracks, valid_test = train_test_split(
                all_tracks, train_size=train_ratio, random_state=seed
            )
            valid_tracks, test_tracks = train_test_split(
                valid_test,
                train_size=valid_ratio / (valid_ratio + test_ratio),
                random_state=seed,
            )
            for tracks, split in (
                (train_tracks, SPLIT.TRAIN),
                (valid_tracks, SPLIT.VALID),
                (test_tracks, SPLIT.TEST),
            ):
                for track in tracks:
                    counts[split.value] += _write_crops(
                        os.path.join(scen_dir, track),
                        subj_idx,
                        scenario,
                        split_dirs[split],
                        nsteps=nsteps,
                        crop_step=crop_step,
                        nmax_points=nmax_points,
                        force_pc_subsampling=force_pc_subsampling,
                        rng=pad_rng,
                    )

    for subj_idx in unseen_classes:
        subject_dir = os.path.join(data_path, SUBJECT_DIR_FMT.format(subj_idx))
        for scenario in sorted(os.listdir(subject_dir)):
            scen_dir = os.path.join(subject_dir, scenario)
            all_tracks = sorted(os.listdir(scen_dir))
            assert all(t[:2] == "pc" for t in all_tracks), (
                f"Invalid file in {scen_dir}"
            )
            for track in all_tracks:
                counts[SPLIT.UNSEEN.value] += _write_crops(
                    os.path.join(scen_dir, track),
                    subj_idx,
                    scenario,
                    split_dirs[SPLIT.UNSEEN],
                    nsteps=nsteps,
                    crop_step=crop_step,
                    nmax_points=nmax_points,
                    force_pc_subsampling=force_pc_subsampling,
                    rng=pad_rng,
                )

    if verbose:
        opns = openness(n_train=len(train_classes), n_test=n_subjects) * 100
        print(
            f"~ New split created! [{time.time() - t0:.3f}s] ~\n"
            f"-> sizes: {counts}\n"
            f"-> Training Classes: {train_classes}\n"
            f"-> Unseen Classes: {unseen_classes}\n"
            f"Openness: {opns:.3f}%"
        )
    return counts
