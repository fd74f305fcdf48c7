"""The port's resume state, on the CPU: an interrupted run continues with
the state of an uninterrupted one.

Mirrors ``tests/test_resume.py`` for the port's own format
(``train/run_folder.py``: a numpy tree through the port's msgpack codec,
tagged in its ``.meta.json``). On the CPU the kernels' plain versions run
and every op is deterministic, so a run of 1 epoch plus a resumed epoch
must equal a run of 2 epochs bit for bit: per-epoch metrics, module files
and the final resume state, for PCAA V4, PCAA V1 (whose mean learner's
running statistics ride in the state) and ORCED (whose noise generator
draws both the train and the valid eps). A resume state written by the
JAX package (``flax.serialization.to_bytes``, no port tag) raises
``ValueError`` and is never read or trained over.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
)
from opensetgaitrecognition_pcaa_tpu.train.run_folder import (
    save_train_state as jax_save_train_state,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    restore_resume_tree,
    resume_tree,
    train_pcaa,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    load_best_payload,
    load_params,
    load_train_state,
    module_path,
    run_completed,
    save_train_state,
)

DIMS = dict(NMAX=24, NSTEPS=8, CROP_STEP=4, POINTNET_OUT_DIM=32,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=8, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8, CHECKPOINT_FREQUENCY=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny: one intra-op thread per process keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    """Seeded crops: 4 train and 2 valid batches."""
    rng = np.random.default_rng(0)

    def split(n):
        x = rng.normal(size=(n, DIMS["NSTEPS"], DIMS["NMAX"], 4)).astype(np.float32)
        return x, (np.arange(n) % 3).astype(np.int32)

    return (*split(32), *split(16))


def _cfg(tmp_path, name, **kw):
    return Config(MODELS_PATH=str(tmp_path), MODEL_NAME=name, **{**DIMS, **kw})


def _state_tensors(mods, state):
    return {**{f"m.{k}": v for k, v in mods.state_dict().items()},
            **{f"mu.{k}": v for k, v in state.opt_g.mu.items()},
            **{f"nu.{k}": v for k, v in state.opt_d.nu.items()}}


class TestStateRoundTrip:
    def test_save_load_identical(self, tmp_path):
        cfg = _cfg(tmp_path, "RT_V4")
        mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
        with torch.no_grad():  # moments and a count that are not the init's
            for t in list(state.opt_g.mu.values()) + list(state.opt_d.nu.values()):
                t.uniform_()
        state.opt_g.count, state.opt_d.count = 7, 7
        torch.randn(3, generator=state.generator)
        rng = np.random.default_rng(7)
        rng.permutation(10)  # advance the stream
        path = os.path.join(str(tmp_path), "ckpt", "train_state.msgpack")
        save_train_state(resume_tree(mods, {"opt_g": state.opt_g, "opt_d": state.opt_d},
                                     state.generator, centroids=state.centroids),
                         4, rng.bit_generator.state, path, extra={"best_valid_acc": 0.5})

        mods2, state2 = build_pcaa(cfg.replace(SEED=9), VARIANTS[VARIATION.V4], device="cpu")
        tree, next_epoch, meta = load_train_state(path)
        assert next_epoch == 5
        assert meta["best_valid_acc"] == 0.5
        restore_resume_tree(tree, mods2, {"opt_g": state2.opt_g, "opt_d": state2.opt_d},
                            state2.generator, centroids=state2.centroids)
        want, got = _state_tensors(mods, state), _state_tensors(mods2, state2)
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
        assert (state2.opt_g.count, state2.opt_d.count) == (7, 7)
        # the noise and the host shuffle streams continue identically
        assert torch.equal(torch.randn(5, generator=state2.generator),
                           torch.randn(5, generator=state.generator))
        rng2 = np.random.default_rng(0)
        rng2.bit_generator.state = meta["host_rng_state"]
        np.testing.assert_array_equal(rng2.permutation(20), rng.permutation(20))

    def test_load_missing_returns_none(self, tmp_path):
        assert load_train_state(str(tmp_path / "nope.msgpack")) is None
        assert load_best_payload(str(tmp_path / "nope.msgpack")) is None

    def test_state_of_another_variant_raises(self, tmp_path):
        mods, state = build_pcaa(_cfg(tmp_path, "A_V1"), VARIANTS[VARIATION.V1], device="cpu")
        path = str(tmp_path / "train_state.msgpack")
        opts = {"opt_g": state.opt_g, "opt_d": state.opt_d}
        save_train_state(resume_tree(mods, opts, state.generator, centroids=state.centroids),
                         0, {}, path)
        mods4, state4 = build_pcaa(_cfg(tmp_path, "A_V4"), VARIANTS[VARIATION.V4], device="cpu")
        with pytest.raises(ValueError, match="differ"):
            restore_resume_tree(load_train_state(path)[0], mods4,
                                {"opt_g": state4.opt_g, "opt_d": state4.opt_d},
                                state4.generator, centroids=state4.centroids)

    def test_jax_written_state_raises(self, tmp_path):
        """A JAX package's ``train_state.msgpack`` (flax bytes, a meta
        without the port's tag) is refused, naming the file, by the loader
        and by both trainers, before they train or write anything."""
        jcfg = JaxConfig(MODELS_PATH=str(tmp_path), MODEL_NAME="J_V4", **DIMS)
        _, jstate = jax_build_pcaa(jcfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
        path = os.path.join(jcfg.run_dir(), "train_state.msgpack")
        jax_save_train_state(jstate, 0, np.random.default_rng(0).bit_generator.state, path,
                             extra={"best_valid_acc": 0.25})
        with pytest.raises(ValueError, match="train_state.msgpack"):
            load_train_state(path)
        x = np.zeros((8, DIMS["NSTEPS"], DIMS["NMAX"], 4), np.float32)
        y = np.zeros(8, np.int32)
        cfg = _cfg(tmp_path, "J_V4", EPOCHS=1)
        for train in (lambda: train_pcaa(cfg, VARIATION.V4, datasets=(x, y, x, y),
                                         verbose=False, device="cpu"),
                      lambda: train_orced(cfg, datasets=(x, y, x, y), verbose=False,
                                          device="cpu")):
            with pytest.raises(ValueError, match="J_V4/train_state.msgpack"):
                train()
            assert sorted(os.listdir(cfg.run_dir())) == [
                "train_state.msgpack", "train_state.msgpack.meta.json"]


def _folder(run_dir):
    """→ (metrics.jsonl lines without their wall clock, run_complete.json
    without the throughput, {file: bytes} of the other files)."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [{k: v for k, v in json.loads(line).items() if k != "_wall"} for line in f]
    with open(os.path.join(run_dir, "run_complete.json")) as f:
        done = {k: v for k, v in json.load(f).items() if k != "windows_per_sec"}
    files = {}
    for name in sorted(os.listdir(run_dir)):
        if name not in ("metrics.jsonl", "run_complete.json", "config.json"):
            with open(os.path.join(run_dir, name), "rb") as f:
                files[name] = f.read()
    return lines, done, files


def _train(kind, cfg, variation, data):
    kw = dict(datasets=data, verbose=False, device="cpu")
    if kind == "orced":
        return train_orced(cfg, **kw)
    return train_pcaa(cfg, variation, **kw)


class TestTrainingResume:
    @pytest.mark.parametrize("kind,variation", [("pcaa", VARIATION.V4), ("pcaa", VARIATION.V1),
                                                ("orced", None)],
                             ids=["pcaa_V4", "pcaa_V1", "orced"])
    def test_interrupted_equals_straight_run(self, tmp_path, arrays, kind, variation):
        name = "RUN_" + (variation.value if variation else "ORCED")
        straight = _cfg(tmp_path / "straight", name, EPOCHS=2, SAVE_RESUME_STATE=True)
        _train(kind, straight, variation, arrays)
        # 1 epoch, then a second call resumes for the second
        resumed = _cfg(tmp_path / "resumed", name, EPOCHS=1, SAVE_RESUME_STATE=True)
        _train(kind, resumed, variation, arrays)
        out = _train(kind, resumed.replace(EPOCHS=2), variation, arrays)
        want, got = _folder(straight.run_dir()), _folder(resumed.run_dir())
        assert [r["_step"] for r in got[0]] == [0, 1]  # one line from each call
        assert got[0] == want[0]
        assert got[1] == want[1]
        assert got[2].keys() == want[2].keys()
        for f in want[2]:
            assert got[2][f] == want[2][f], f
        assert np.isfinite(out["windows_per_sec"])

    def test_resume_preserves_best_payload(self, tmp_path, arrays):
        """A resumed run whose epochs never beat the restored best accuracy
        writes the saved best weights, not its final state."""
        cfg = _cfg(tmp_path, "BESTKEEP_V4", EPOCHS=1, SAVE_RESUME_STATE=True)
        train_pcaa(cfg, VARIATION.V4, datasets=arrays, verbose=False, device="cpu")
        ckpt = os.path.join(cfg.run_dir(), "train_state.msgpack")
        assert os.path.exists(ckpt + ".best"), "best payload not persisted"
        with open(ckpt + ".meta.json") as f:
            meta = json.load(f)
        meta["best_valid_acc"] = 1.0  # unbeatable: no resumed epoch improves
        with open(ckpt + ".meta.json", "w") as f:
            json.dump(meta, f)

        train_pcaa(cfg.replace(EPOCHS=3), VARIATION.V4, datasets=arrays, verbose=False,
                   device="cpu")
        best = load_best_payload(ckpt)
        enc = load_params(module_path(cfg.run_dir(), cfg.MODEL_NAME, "E"))
        kernel = enc["params"]["MLP_sup1"]["kernel"]
        np.testing.assert_array_equal(kernel, best["g.encoder.MLP_sup1.weight"].T)
        final = load_train_state(ckpt)[0]["modules"]["g.encoder.MLP_sup1.weight"].T
        assert not np.array_equal(kernel, final)  # two more epochs moved the weights

    def test_run_completed_marker(self, tmp_path, arrays):
        cfg = _cfg(tmp_path, "MARKER_V4", EPOCHS=1)
        assert not run_completed(cfg.run_dir())
        train_pcaa(cfg, VARIATION.V4, datasets=arrays, verbose=False, device="cpu")
        assert run_completed(cfg.run_dir())
        with open(os.path.join(cfg.run_dir(), "run_complete.json")) as f:
            assert "Valid Accuracy" in json.load(f)
        assert not os.path.exists(os.path.join(cfg.run_dir(), "train_state.msgpack"))
