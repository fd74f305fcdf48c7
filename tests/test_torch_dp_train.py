"""The port's trainers at DP 2 and DP 2 × MP 2 against their single-device
runs, on the CPU: ``tests/test_dp.py``'s four tests (which hold the JAX
package's trainers at DP 8 and DP 4 × MP 2 to its single-device run),
mirrored with ranks of gloo (``parallel/mesh.py::launch``) and
``MP_MIN_DIM=16``, so that the tiny layers' kernels are sharded; and the run
folder a sharded run writes.

The same math on every layout, so the metrics agree up to the order of the
sums: rel 1e-3, ``tests/test_dp.py``'s bound, on its keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import SPLIT as JAX_SPLIT
from opensetgaitrecognition_pcaa_tpu.data.dataset import RadarCropDataset

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import train_pcaa
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    load_params,
    load_train_state,
    run_completed,
)

PCAA_KEYS = ("Total Loss Train", "Discriminator Loss", "Train Accuracy")
ORCED_KEYS = ("Total Loss Train", "Reconstruction Loss Train", "Triplet Loss", "Train Accuracy")
LAYOUTS = {"dp2": dict(DP_DEVICES=2), "dp2_mp2": dict(DP_DEVICES=2, MP_DEVICES=2, MP_MIN_DIM=16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here and in each rank (which reads the variable when
    it imports torch): the xdist workers and the ranks share the cores."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def arrays(generated_splits):
    """The ``generated_splits`` fixture's splits, cut to 128 train crops
    (16 steps of B 8) and 32 valid ones to keep the file's time: eight
    runs train here."""
    gen, _ = generated_splits
    x_t, y_t = RadarCropDataset(JAX_SPLIT.TRAIN, gen).load_all()
    x_v, y_v = RadarCropDataset(JAX_SPLIT.VALID, gen).load_all()
    return x_t[:128], y_t[:128], x_v[:32], y_v[:32]


def _cfg(gen, root, name, **kw):
    """``tests/test_train.py::tiny_config``'s dims, one epoch; the resume
    state written, so that it is written from a sharded run too."""
    return Config(NMAX=64, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
                  DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
                  BATCH_SIZE=8, EPOCHS=1, CHECKPOINT_FREQUENCY=1, SAVE_RESUME_STATE=True,
                  GEN_DATA_PATH=gen, MODELS_PATH=os.path.join(str(root), "models"),
                  FIGURES_PATH=os.path.join(str(root), "figures"), MODEL_NAME=name, **kw)


class _Runs(dict):
    """(kind, layout) → (single-device config and metrics, sharded config
    and metrics), each trained once."""

    def __init__(self, gen, root, arrays):
        super().__init__()
        self.gen, self.root, self.arrays = gen, root, arrays

    def __missing__(self, key):
        kind, layout = key
        fn, extra = (train_pcaa, dict(variation=VARIATION.V4)) if kind == "pcaa" else (
            train_orced, dict(resume=False))
        tag = "V4" if kind == "pcaa" else "ORCED"
        solo = _cfg(self.gen, self.root, f"{layout}_1_{tag}")
        sharded = _cfg(self.gen, self.root, f"{layout}_N_{tag}", **LAYOUTS[layout])
        common = dict(datasets=self.arrays, verbose=False, device="cpu", **extra)
        out1 = fn(solo, **common)
        n = sharded.DP_DEVICES * sharded.MP_DEVICES
        outn = launch(fn, n, sharded, backend="gloo", **common)
        self[key] = (solo, out1, sharded, outn)
        return self[key]


@pytest.fixture(scope="module")
def runs(generated_splits, tmp_path_factory, arrays):
    return _Runs(generated_splits[0], tmp_path_factory.mktemp("dp_train"), arrays)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pcaa_training_matches_single_device(runs, layout):
    """``tests/test_dp.py::test_dp_training_matches_single_device`` (dp2)
    and ``::test_dp_tp_training_matches_single_device`` (dp2_mp2)."""
    _, out1, _, outn = runs["pcaa", layout]
    for k in PCAA_KEYS:
        assert outn[k] == pytest.approx(out1[k], rel=1e-3), k
    assert outn["best_valid_accuracy"] == out1["best_valid_accuracy"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_orced_training_matches_single_device(runs, layout):
    """``tests/test_dp.py::test_orced_dp_training_matches_single_device``
    (dp2) and ``::test_orced_dp_tp_training_matches_single_device``
    (dp2_mp2)."""
    _, out1, _, outn = runs["orced", layout]
    for k in ORCED_KEYS:
        assert outn[k] == pytest.approx(out1[k], rel=1e-3), k


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], prefix + (key,)).items()}
    return {prefix: np.shape(tree)}


@pytest.mark.parametrize("kind", ["pcaa", "orced"])
def test_sharded_run_folder_is_a_single_device_one(runs, kind, tmp_path):
    """The DP 2 × MP 2 run's folder has the single-device run's file names
    and, in every module file and the resume state, its keys and shapes
    (rank 0 writes gathered full trees); the V4 folder scores in the
    port's ``pcaa_inference``."""
    solo, _, sharded, _ = runs[kind, "dp2_mp2"]
    rename = {solo.MODEL_NAME: sharded.MODEL_NAME}
    files1 = sorted(os.listdir(solo.run_dir()))
    filesn = sorted(os.listdir(sharded.run_dir()))
    assert filesn == sorted(f.replace(*next(iter(rename.items()))) for f in files1)
    assert run_completed(sharded.run_dir())
    for f in files1:
        a, b = os.path.join(solo.run_dir(), f), os.path.join(sharded.run_dir(), f.replace(
            solo.MODEL_NAME, sharded.MODEL_NAME))
        if f.endswith(".msgpack") and not f.startswith("train_state"):
            assert _shapes(load_params(b)) == _shapes(load_params(a)), f
        elif f == "metrics.jsonl":
            with open(a) as fa, open(b) as fb:
                assert [json.loads(line).keys() for line in fa] == \
                    [json.loads(line).keys() for line in fb]
    tree1, epoch1, _ = load_train_state(os.path.join(solo.run_dir(), "train_state.msgpack"))
    treen, epochn, _ = load_train_state(os.path.join(sharded.run_dir(), "train_state.msgpack"))
    assert epochn == epoch1 and _shapes(treen) == _shapes(tree1)
    assert Config.load(os.path.join(sharded.run_dir(), "config.json")) == sharded
    if kind == "pcaa":
        logs = pcaa_inference([sharded.MODEL_NAME], ks=[1], models_path=sharded.MODELS_PATH,
                              figures_path=str(tmp_path), generate_dataset=False,
                              variation=VARIATION.V4, device="cpu")
        assert np.isfinite(logs[sharded.MODEL_NAME][1]["f1_micro"])
