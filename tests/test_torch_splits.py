"""The port's raw-track pipeline against the JAX package's: the split
recipe against sklearn, the preprocessing, the synthetic generator and
``generate_splits`` file by file, all bit-equal, on the CPU.
"""

import os
import pickle

import numpy as np
import pytest
from sklearn.model_selection import train_test_split as sk_train_test_split

from opensetgaitrecognition_pcaa_tpu.data import preprocess as jax_preprocess
from opensetgaitrecognition_pcaa_tpu.data.splits import generate_splits as jax_generate_splits

from opensetgaitrecognition_pcaa_tpu_torch.data import preprocess
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits, train_test_split
from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

SPLIT_ARGS = dict(train_classes=[0, 1, 2], seed=0, nmax_points=48, nsteps=12, crop_step=4,
                  n_subjects=5, verbose=False)
RAW_ARGS = dict(n_subjects=5, tracks_per_scenario=10, frames_per_track=(40, 56), seed=7)


def _sklearn(items, ratio, seed):
    try:
        train, test = sk_train_test_split(items, train_size=ratio, random_state=seed)
    except ValueError as e:
        return str(e)
    return list(train), list(test)


def _port(items, ratio, seed):
    try:
        return train_test_split(items, train_size=ratio, random_state=seed)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize(
    "ratio,seed,sizes",
    [(0.8, 0, range(2, 200)), (0.8, 1, range(2, 200)), (0.8, 42, range(2, 200)),
     (0.5, 0, range(2, 200)), (0.5, 1, range(2, 200)), (0.5, 42, range(2, 200)),
     (0.8, 0, (0, 1)), (0.5, 3, (0, 1))],
    ids=["r0.8_s0", "r0.8_s1", "r0.8_s42", "r0.5_s0", "r0.5_s1", "r0.5_s42",
         "empty_r0.8", "empty_r0.5"],
)
def test_split_recipe_equals_sklearn(ratio, seed, sizes):
    """The same tracks in each part for every n (``1 − 0.8`` is
    0.19999999999999996 in f64), and sklearn's ValueError where a part
    comes out empty."""
    for n in sizes:
        items = [f"pc_tr{i}.pkl" for i in range(n)]
        want = _sklearn(items, ratio, seed)
        assert _port(items, ratio, seed) == want, n
        if n < 2:
            assert isinstance(want, str) and "empty" in want


def test_preprocess_crops_are_bit_equal(synthetic_raw):
    """One track through both packages' preprocessing, with and without
    forced subsampling, the rng drawn in the same order: the same crops."""
    path = os.path.join(synthetic_raw, "target1", "smartphone", "pc_tr3.pkl")
    for force in (0, 30, 1000):
        got = preprocess.process_track(path, nmax=48, force_pc_subsampling=force,
                                       rng=np.random.default_rng(9))
        want = jax_preprocess.process_track(path, nmax=48, force_pc_subsampling=force,
                                            rng=np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(preprocess.crop_with_step(got, 12, 4),
                                      jax_preprocess.crop_with_step(want, 12, 4))
    with open(path, "rb") as f:
        frames = pickle.load(f)
    for nfeatures in (4, 5):
        np.testing.assert_array_equal(
            preprocess.process_frames(frames, nmax=64, nfeatures=nfeatures, divide_by_std=True),
            jax_preprocess.process_frames(frames, nmax=64, nfeatures=nfeatures,
                                          divide_by_std=True))
    assert preprocess.crop_with_step(np.zeros((12, 3)), 12, 4).shape == (0, 12, 3)


@pytest.fixture(scope="module")
def port_raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_raw"))
    generate_synthetic_raw_dataset(root, **RAW_ARGS)
    return root


def test_synthetic_tracks_equal_the_jax_package(port_raw, synthetic_raw):
    """The conftest's JAX-written raw set and the port's, same arguments:
    the same files, and every pickle's frames load equal."""
    n = 0
    for dirpath, _, files in os.walk(synthetic_raw):
        rel = os.path.relpath(dirpath, synthetic_raw)
        assert sorted(os.listdir(os.path.join(port_raw, rel))) == sorted(os.listdir(dirpath))
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                want = pickle.load(f)
            with open(os.path.join(port_raw, rel, name), "rb") as f:
                got = pickle.load(f)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for key in w:
                    np.testing.assert_array_equal(g[key], w[key])
            n += 1
    assert n == 5 * 3 * 10


def assert_splits_equal(got_dir, want_dir):
    """The four split directories hold the same files, bit-equal."""
    for split in ("train", "valid", "test", "unseen"):
        names = sorted(os.listdir(os.path.join(want_dir, split)))
        assert sorted(os.listdir(os.path.join(got_dir, split))) == names and names, split
        for name in names:
            got = np.load(os.path.join(got_dir, split, name))
            want = np.load(os.path.join(want_dir, split, name))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("force", [0, 20], ids=["all_points", "subsampled20"])
@pytest.mark.parametrize("raw", ["jax_raw", "port_raw"])
def test_generate_splits_equals_the_jax_package(raw, force, port_raw, synthetic_raw, tmp_path):
    data = synthetic_raw if raw == "jax_raw" else port_raw
    want = jax_generate_splits(data_path=data, gen_data_path=str(tmp_path / "jax"),
                               force_pc_subsampling=force, **SPLIT_ARGS)
    # a stale file in a split directory is wiped, as the JAX package wipes it
    os.makedirs(tmp_path / "port" / "train")
    (tmp_path / "port" / "train" / "stale.npy").write_bytes(b"")
    got = generate_splits(data_path=data, gen_data_path=str(tmp_path / "port"),
                          force_pc_subsampling=force, **SPLIT_ARGS)
    assert got == want
    assert_splits_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_generate_splits_prints_the_openness(synthetic_raw, tmp_path, capsys):
    generate_splits(data_path=synthetic_raw, gen_data_path=str(tmp_path),
                    **{**SPLIT_ARGS, "verbose": True})
    out = capsys.readouterr().out
    assert "New split created" in out and "Openness: 13.397%" in out
