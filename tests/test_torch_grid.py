"""The port's lockstep grid trainers (``parallel/grid.py``) on the CPU.

- The helpers equal the JAX package's on a table of inputs (every case of
  ``tests/test_grid.py``'s ``mesh_chunks`` tests, ragged, empty and
  single-run lists); the lockstep checks raise with the JAX messages.
- ``GridPCAATrainer`` run r is the port's solo run r (``make_epoch_fns``'s
  ``train_epoch`` from ``build_pcaa`` with run r's seed, the batches of
  ``epoch_batch_indices`` from ``default_rng(SEED)``), for V4 and V1:
  per-step metrics, parameters, running statistics, Adam moments and the
  noise generator's state are ``torch.equal`` after an epoch, also with
  uneven train sets (run 1's trailing lockstep steps masked) and uneven
  valid sets scored per run against the solo ``valid_epoch``.
- ``GridPCAATrainer``'s epoch means and validation accuracies equal the
  JAX ``GridPCAATrainer``'s: each JAX run's initial state carried into the
  port (``convert.pcaa_state_from_jax``), the same uneven train and valid
  sets, the same permutations (``default_rng(SEED)`` on both sides) and
  the JAX runs' own noise replayed from their keys into the port's
  ``train_epoch``: the (R,) loss means at rtol 1e-4 (f32 sums in other
  orders through the decoder and the Chamfer loss, as
  ``tests/test_torch_train.py`` holds three steps), the accuracies exact.
- ``GridORCEDTrainer`` run r is ``train_orced`` on the same configuration:
  3 epochs at ``CHECKPOINT_FREQUENCY=2``, so that epoch 1 is validated by
  the solo trainer but not checkpointed, and epoch 2 trains on the noise
  drawn after that validation: per-epoch losses equal, the best E, G and
  ML files equal, and the final live state equal to the resume state the
  solo trainer writes at epoch 2.

Tiny dims (``tests/test_scripts.py``'s TINY, NMAX 24, NSTEPS 8), seeded
crops, one torch thread.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.parallel import grid as jax_grid

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import pcaa_state_from_jax
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
from opensetgaitrecognition_pcaa_tpu_torch.parallel import grid
from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import (
    GridORCEDTrainer,
    GridPCAATrainer,
    mesh_chunks,
    pad_datasets,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced, write_orced_checkpoint
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    _ckpt_payload,
    build_pcaa,
    make_epoch_fns,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    load_params,
    load_train_state,
    module_path,
)

from tests.test_scripts import TINY

DIMS = {**TINY, "TRAIN_CLASSES": (0, 1, 2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    """Seeded crops: 40 train (5 batches of 8) and 20 valid (2 batches)."""
    rng = np.random.default_rng(0)

    def split(n):
        x = rng.normal(size=(n, DIMS["NSTEPS"], DIMS["NMAX"], 4)).astype(np.float32)
        return x, (np.arange(n) % 3).astype(np.int32)

    return (*split(40), *split(20))


def _cfgs(tmp_path, base, n=2, **kw):
    return [Config(MODELS_PATH=str(tmp_path), MODEL_NAME=f"{base}{r}", SEED=r, **{**DIMS, **kw})
            for r in range(n)]


# --- the helpers ------------------------------------------------------------------------

MESH_CASES = {  # tests/test_grid.py::TestMeshChunks, then more
    "exact_multiple": (16, 16, 8),
    "ragged_tail": (21, 16, 8),
    "below_mesh_size": (5, 16, 8),
    "single_device_cap": (5, 2, 1),
    "empty": (0, 2, 1),
    "empty_mesh": (0, 16, 8),
    "single_run": (1, 2, 1),
    "single_run_mesh": (1, 16, 8),
    "ragged_single_device": (7, 3, 1),
    "ragged_two_devices": (11, 6, 2),
    "cap_below_devices": (9, 3, 4),
    "no_devices": (4, 3, 0),
}


@pytest.mark.parametrize("n,cap,n_dev", list(MESH_CASES.values()), ids=list(MESH_CASES))
def test_mesh_chunks_equal_the_jax_function(n, cap, n_dev):
    todo = [3 * i + 1 for i in range(n)]
    got = mesh_chunks(todo, cap, n_dev)
    assert got == jax_grid.mesh_chunks(todo, cap, n_dev)
    assert sum((c for c, _ in got), []) == todo


def _sets(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 3, 4, 2)).astype(np.float32),
             rng.integers(0, 5, n).astype(np.int32)) for n in sizes]


@pytest.mark.parametrize("sizes", [(10, 7), (6, 6, 6), (1,), (4, 9, 1), (5, 1)],
                         ids=["ragged", "equal", "single_run", "three_ragged", "one_crop_run"])
def test_pad_datasets_equal_the_jax_function(sizes):
    got, want = pad_datasets(_sets(sizes)), jax_grid.pad_datasets(_sets(sizes))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_per_run_fields_are_the_jax_package_s():
    assert grid._PER_RUN_FIELDS == jax_grid._PER_RUN_FIELDS


@pytest.mark.parametrize("field,value", [("NMAX", 32), ("BATCH_SIZE", 16), ("LR", 3e-4),
                                         ("EPOCHS", 7), ("COMPUTE_DTYPE", "bfloat16")])
def test_lockstep_check_raises_the_jax_message(tmp_path, field, value):
    cfgs = _cfgs(tmp_path, "M")
    cfgs[1] = cfgs[1].replace(**{field: value})
    with pytest.raises(AssertionError) as got:
        grid._assert_lockstep_compatible(cfgs)
    with pytest.raises(AssertionError) as want:
        jax_grid._assert_lockstep_compatible([JaxConfig.from_dict(c.to_dict()) for c in cfgs])
    assert str(got.value) == str(want.value)
    assert f"{field}=" in str(got.value) and "only per-run" in str(got.value)
    # the per-run fields may differ
    grid._assert_lockstep_compatible([cfgs[0], cfgs[0].replace(
        SEED=9, MODEL_NAME="other", TRAIN_CLASSES=(3, 4, 5), GEN_DATA_PATH="g", NOTES="n")])


@pytest.mark.parametrize("trainer", ["pcaa", "orced"])
def test_trainers_check_before_building(tmp_path, arrays, trainer):
    """Mismatched shapes and hyperparameters, a valid split below one batch,
    an empty mesh (a list of devices) and DEFERRED_DECODER_UPDATE (with the
    JAX grid's words: a solo-trainer schedule) raise, as
    tests/test_grid.py::test_orced_grid_rejects_mismatched_shapes holds the
    JAX trainers."""
    x_t, y_t, x_v, y_v = arrays

    def make(cfgs, **kw):
        if trainer == "pcaa":
            return GridPCAATrainer(cfgs, VARIATION.V4, [(x_t, y_t)] * len(cfgs), device="cpu",
                                   **kw)
        return GridORCEDTrainer(cfgs, [(x_t, y_t)] * len(cfgs), device="cpu", **kw)

    cfgs = _cfgs(tmp_path, "C")
    for field, value in (("NMAX", 32), ("BATCH_SIZE", 16), ("LR", 3e-4)):
        with pytest.raises(AssertionError, match=fr"{field}.*only per-run"):
            make([cfgs[0], cfgs[1].replace(**{field: value})])
    with pytest.raises(AssertionError, match="mismatched n_classes"):
        make([cfgs[0], cfgs[1].replace(TRAIN_CLASSES=(0, 1))])
    with pytest.raises(AssertionError, match=r"must be >= BATCH_SIZE=8"):
        make(cfgs, valid_sets=[(x_v, y_v), (x_v[:7], y_v[:7])])
    with pytest.raises(ValueError, match="list of devices; it is empty"):
        make(cfgs, mesh=[])
    if trainer == "pcaa":
        with pytest.raises(AssertionError, match="DEFERRED_DECODER_UPDATE is a solo-trainer "
                                                 "schedule"):
            make([c.replace(DEFERRED_DECODER_UPDATE=True) for c in cfgs])


# --- PCAA: grid run r is solo run r -------------------------------------------------------

def _assert_state_equal(g_mods, g_state, s_mods, s_state):
    for (k, a), (_, b) in zip(g_mods.state_dict().items(), s_mods.state_dict().items()):
        assert torch.equal(a, b), k
    for g_opt, s_opt in ((g_state.opt_g, s_state.opt_g), (g_state.opt_d, s_state.opt_d)):
        assert g_opt.count == s_opt.count
        for part in ("mu", "nu"):
            for k, a in getattr(g_opt, part).items():
                assert torch.equal(a, getattr(s_opt, part)[k]), (part, k)
    assert torch.equal(g_state.generator.get_state(), s_state.generator.get_state())


def _solo_pcaa(cfg, variation, x, y, xv, yv, epochs):
    """The port's solo run: build_pcaa + make_epoch_fns, the solo trainer's
    batches, → (mods, state, per-epoch step metrics, valid n_correct)."""
    mods, state = build_pcaa(cfg, VARIANTS[variation], device="cpu")
    train_epoch, valid_epoch = make_epoch_fns(mods, cfg)
    rng = np.random.default_rng(cfg.SEED)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    steps = []
    for _ in range(epochs):
        state, m = train_epoch(state, xt, yt,
                               epoch_batch_indices(len(x), cfg.BATCH_SIZE, True, rng=rng))
        steps.append(m)
    vm = valid_epoch(state, torch.from_numpy(xv), torch.from_numpy(yv),
                     epoch_batch_indices(len(xv), cfg.BATCH_SIZE, False))
    return mods, state, steps, float(vm["n_correct"].sum())


@pytest.mark.parametrize("variation,uneven", [(VARIATION.V4, False), (VARIATION.V1, False),
                                              (VARIATION.V4, True)],
                         ids=["V4", "V1", "V4_uneven"])
def test_pcaa_grid_run_is_the_solo_run(tmp_path, arrays, variation, uneven):
    """Two epochs of two runs (seeds 0 and 1); ``uneven``: run 1 trains on
    the first 27 crops (3 steps of the lockstep's 5, its last 2 masked) and
    is validated on the first 12 (1 batch of the 2)."""
    x_t, y_t, x_v, y_v = arrays
    sets = [(x_t, y_t, x_v, y_v), (x_t[:27], y_t[:27], x_v[:12], y_v[:12]) if uneven
            else (x_t, y_t, x_v, y_v)]
    cfgs = _cfgs(tmp_path, "G")
    trainer = GridPCAATrainer(cfgs, variation, [s[:2] for s in sets], [s[2:] for s in sets],
                              device="cpu")
    assert trainer.R == 2 and trainer.cfg is trainer.cfgs[0]
    assert list(trainer._steps_per_run) == [5, 3 if uneven else 5]
    epochs = [trainer.run_epoch(e) for e in range(2)]
    grid_steps = trainer.last_epoch_steps
    accs = trainer.valid_accuracy()
    for r, (cfg, (x, y, xv, yv)) in enumerate(zip(cfgs, sets)):
        mods, state, steps, n_correct = _solo_pcaa(cfg, variation, x, y, xv, yv, 2)
        for k, v in steps[-1].items():
            assert torch.equal(grid_steps[r][k], v), k
        g_mods, g_state = trainer.per_run_states()[r]
        _assert_state_equal(g_mods, g_state, mods, state)
        vsteps = len(xv) // cfg.BATCH_SIZE
        assert accs[r] * vsteps * cfg.BATCH_SIZE == n_correct
        # the epoch's means: accuracy over the run's steps, CE and total
        # over its supervised steps
        m, s = epochs[-1], {k: v.numpy() for k, v in steps[-1].items()}
        sup = np.arange(len(s["tot_loss"])) % cfg.SUPERVISION_FREQUENCY == 0
        assert m["train_accuracy"][r] == float(s["n_correct"].sum()) / (len(s["n_correct"]) * 8)
        np.testing.assert_allclose(m["tot_loss"][r], s["tot_loss"][sup].mean(), rtol=1e-6)
        np.testing.assert_allclose(m["sup_loss"][r], s["sup_loss"][sup].mean(), rtol=1e-6)
        np.testing.assert_allclose(m["d_loss"][r], s["d_loss"].mean(), rtol=1e-6)
        assert all(np.isfinite(v[r]) for v in m.values())
    assert abs(epochs[0]["tot_loss"][0] - epochs[0]["tot_loss"][1]) > 1e-6  # distinct seeds


def test_pcaa_grid_over_a_device_list_is_the_solo_runs(tmp_path, arrays):
    """A ``mesh`` of devices (JAX's run axis sharded over them): run r and
    all of its state on ``mesh[r % len(mesh)]``, each still its own solo
    run, bit for bit; three runs over two devices."""
    x_t, y_t, x_v, y_v = arrays
    cfgs = _cfgs(tmp_path, "L", n=3)
    trainer = GridPCAATrainer(cfgs, VARIATION.V4, [(x_t, y_t)] * 3, [(x_v, y_v)] * 3,
                              mesh=["cpu", "cpu"])
    assert [str(d) for d in trainer.run_devices] == ["cpu", "cpu", "cpu"]
    trainer.run_epoch(0)
    accs = trainer.valid_accuracy()
    for r, cfg in enumerate(cfgs):
        mods, state, _, n_correct = _solo_pcaa(cfg, VARIATION.V4, x_t, y_t, x_v, y_v, 1)
        _assert_state_equal(*trainer.per_run_states()[r], mods, state)
        assert accs[r] * (len(x_v) // cfg.BATCH_SIZE) * cfg.BATCH_SIZE == n_correct


def test_pcaa_grid_keeps_the_best_payload_per_run(tmp_path, arrays):
    """note_validation starts at −inf and keeps strictly better runs;
    best_run_payloads gives each run's kept weights (its current ones where
    none was kept)."""
    x_t, y_t, _, _ = arrays
    cfgs = _cfgs(tmp_path, "B")
    trainer = GridPCAATrainer(cfgs, VARIATION.V4, [(x_t, y_t)] * 2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        trainer.best_run_payloads()[0].values(), _ckpt_payload(trainer.mods[0]).values()))
    assert list(trainer.note_validation(np.array([0.0, 0.5]))) == [True, True]
    kept = [{k: v.clone() for k, v in p.items()} for p in trainer.best_run_payloads()]
    trainer.run_epoch(0)
    assert list(trainer.note_validation(np.array([0.0, 0.75]))) == [False, True]
    assert list(trainer._best_accs) == [0.0, 0.75]
    best = trainer.best_run_payloads()
    now = [_ckpt_payload(m) for m in trainer.mods]
    assert all(torch.equal(best[0][k], kept[0][k]) for k in kept[0])
    assert all(torch.equal(best[1][k], now[1][k]) for k in now[1])
    assert not all(torch.equal(best[0][k], now[0][k]) for k in now[0])


def _jax_noise(key, steps: int, batch: int, latent: int):
    """The (z0, alphas) a JAX PCAA step draws from its carried key, for
    ``steps`` steps (``train/pcaa.py``'s step: ``split(key, 3)``, then
    ``normal`` and ``uniform``)."""
    z0, alphas = [], []
    for _ in range(steps):
        key, k_z, k_alpha = jax.random.split(key, 3)
        z0.append(np.asarray(jax.random.normal(k_z, (batch, latent))))
        alphas.append(np.asarray(jax.random.uniform(k_alpha, (batch, 1))))
    return torch.from_numpy(np.stack(z0)), torch.from_numpy(np.stack(alphas))


def test_pcaa_grid_means_equal_the_jax_grid(tmp_path, arrays):
    """One epoch of two runs, run 0 on 24 train crops (3 steps, step 1
    unsupervised at SUPERVISION_FREQUENCY 2) and 20 valid, run 1 on 17
    (2 steps; the JAX grid masks its third) and 12 valid."""
    x_t, y_t, x_v, y_v = arrays
    train = [(x_t[:24], y_t[:24]), (x_t[:17], y_t[:17])]
    valid = [(x_v, y_v), (x_v[:12], y_v[:12])]
    jcfgs = [JaxConfig(MODELS_PATH=str(tmp_path), MODEL_NAME=f"J{r}V4", SEED=r,
                       SUPERVISION_FREQUENCY=2, **DIMS) for r in range(2)]
    jt = jax_grid.GridPCAATrainer(jcfgs, JAX_VARIATION.V4, train, valid)
    pt = GridPCAATrainer([Config.from_dict(c.to_dict()) for c in jcfgs], VARIATION.V4, train,
                         valid, device="cpu")
    B, latent = DIMS["BATCH_SIZE"], DIMS["SUP_LATENT_DIM"]
    for r, state in enumerate(jt.per_run_states()):
        tree = jax.device_get({
            "params_g": state.params_g, "params_d": state.params_d,
            "batch_stats": state.batch_stats, "centroids": state.centroids,
            **{k: {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}
               for k, o in (("opt_g", state.opt_g), ("opt_d", state.opt_d))}})
        pcaa_state_from_jax(tree, pt.mods[r], pt.states[r])
        noise = _jax_noise(state.key, int(jt._steps_per_run[r]), B, latent)
        pt._train_epochs[r] = functools.partial(pt._train_epochs[r], noise=noise)
    assert list(pt._steps_per_run) == list(jt._steps_per_run) == [3, 2]

    got, want = pt.run_epoch(0), jt.run_epoch(0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k == "train_accuracy":
            assert np.array_equal(got[k], want[k]), (got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    assert np.array_equal(pt.valid_accuracy(), jt.valid_accuracy())


# --- ORCED: grid run r is train_orced's run r ----------------------------------------------

def test_orced_grid_run_is_train_orced(tmp_path, arrays):
    x_t, y_t, x_v, y_v = arrays
    cfgs = _cfgs(tmp_path / "solo", "O", EPOCHS=3, CHECKPOINT_FREQUENCY=2,
                 SAVE_RESUME_STATE=True, TRIPLET_W=1.0, CE_W=1.0, REC_W=1.0, KL_W=1.0,
                 TRIPLET_MARGIN=0.5)
    for cfg in cfgs:
        train_orced(cfg, datasets=(x_t, y_t, x_v, y_v), device="cpu", verbose=False)

    trainer = GridORCEDTrainer([c.replace(SAVE_RESUME_STATE=False) for c in cfgs],
                               [(x_t, y_t)] * 2, [(x_v, y_v)] * 2, device="cpu")
    # the driver's loop: validation noted on checkpoint epochs only
    losses = []
    for epoch in range(3):
        trainer.run_epoch(epoch)
        losses.append([{k: float(np.mean(v.numpy())) for k, v in s.items()}
                       for s in trainer.last_epoch_steps])
        if epoch % 2 == 0:
            trainer.note_validation(trainer.valid_accuracy(epoch))
    with pytest.raises(ValueError, match="not the last epoch"):
        trainer.valid_accuracy(1)
    names = {"Reconstruction Loss Train": "rec_loss", "Cross Entropy Loss Train": "sup_loss",
             "Triplet Loss": "trip_loss", "KL Loss": "kl_loss", "Total Loss Train": "tot_loss"}
    for r, (cfg, payload) in enumerate(zip(cfgs, trainer.best_run_payloads())):
        with open(os.path.join(cfg.run_dir(), "metrics.jsonl")) as f:
            solo = [json.loads(line) for line in f]
        assert len(solo) == 3
        for epoch, rec in enumerate(solo):
            for key, k in names.items():
                assert rec[key] == losses[epoch][r][k], (r, epoch, key)
        assert trainer._best_accs[r] == pytest.approx(
            max(rec["Valid Accuracy"] for e, rec in enumerate(solo) if e % 2 == 0), abs=1e-6)
        out = str(tmp_path / "grid" / cfg.MODEL_NAME)
        write_orced_checkpoint(out, cfg.MODEL_NAME, payload)
        for tag in ("E", "G", "ML"):
            a = load_params(module_path(cfg.run_dir(), cfg.MODEL_NAME, tag))
            b = load_params(module_path(out, cfg.MODEL_NAME, tag))
            for (ka, va), (kb, vb) in zip(_flat(a), _flat(b)):
                assert ka == kb and np.array_equal(va, vb), (tag, ka)
        # the solo run's resume state, written after epoch 2's validation
        tree, epoch, _ = load_train_state(os.path.join(cfg.run_dir(), "train_state.msgpack"))
        mods, state = trainer.per_run_states()[r]
        assert epoch == 3  # the epoch a resume would start at
        for k, v in mods.state_dict().items():
            assert np.array_equal(tree["modules"][k], v.numpy()), k
        assert np.array_equal(np.asarray(tree["generator"]), state.generator.get_state().numpy())
    assert losses[0][0]["kl_loss"] == 0.0 and losses[1][0]["kl_loss"] != 0.0


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k])

