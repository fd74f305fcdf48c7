"""``BF16_WEIGHT_CACHE`` on the CPU: the decoder's bf16 weight copies
change no bit of a bf16 run.

The JAX package holds its cache on against off bitwise
(``tests/test_optim.py::TestBF16WeightCache``); so does the port, for the
V4 step (plain, and with ``FUSED_POINTNET``/``FUSED_ADAM``, whose Adam
writes the copy, at bf16 and bf16 + nu16) and the ORCED step, at tiny
dims from one seeded state on seeded inputs: losses, parameters, running
statistics and Adam moments after 3 steps equal bitwise. Below them: the
dense layer reading the copy, bitwise; the card's route for a bf16 dense
layer (``models/layers.py::Bf16Dense``: bf16 GEMMs, f32 accumulation) run
on the CPU against the CPU route; the Adam update writing the copy against
the JAX package's ``fused_adam_tree_update`` followed by its
``_cache_tree``; the grid with the cache against solo runs; and the
refusals JAX makes (f32 compute, a variant without a decoder). Under
tensor parallelism (2 gloo ranks, ``tests/torch_ranks.py``) the copies
are the shards of their masters: cache on against off bitwise there too.

Tolerances and their reasons: the cache comparisons are bitwise (the same
bf16 operands in the same operations). ``Bf16Dense`` against the CPU
route: both form each product exactly in f32 and sum in another order
(one GEMM with the bias, or a GEMM and an add), then round to bf16, so a
value may land one bf16 step apart: rtol 2^-7 against each output's
largest magnitude. Adam against JAX: ``tests/test_torch_adam.py``'s TOL,
and the copy is the bf16 rounding of each side's own weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.ops.pallas.adam_kernel import (
    fused_adam_tree_update as jax_fused_adam_tree_update,
)
from opensetgaitrecognition_pcaa_tpu.train.pcaa import _cache_tree

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
from opensetgaitrecognition_pcaa_tpu_torch.models.layers import Bf16Dense, dense, round_bf16
from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridORCEDTrainer, GridPCAATrainer
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
    build_orced,
    make_orced_epoch_fns,
    make_orced_train_step,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    make_epoch_fns,
    make_train_step,
)
from tests.test_torch_adam import TOL as ADAM_TOL
from tests.torch_ranks import pcaa_steps

DIMS = dict(NMAX=48, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8, SUPERVISION_FREQUENCY=2)
STEPS = 3
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = STEPS * DIMS["BATCH_SIZE"]
    return dict(
        x=torch.from_numpy(rng.normal(size=(n, 12, 48, 4)).astype(np.float32)),
        y=torch.from_numpy((np.arange(n) % 3).astype(np.int64)),
        perm=rng.permutation(n).reshape(STEPS, DIMS["BATCH_SIZE"]),
        z0=torch.from_numpy(rng.normal(size=(STEPS, 8, 16)).astype(np.float32)),
        alphas=torch.from_numpy(rng.uniform(size=(STEPS, 8, 1)).astype(np.float32)),
    )


def _state(mods, opts) -> dict:
    out = {f"m.{k}": v for k, v in mods.state_dict().items()}
    for i, o in enumerate(opts):
        out[f"count{i}"] = torch.tensor(o.count)
        out.update({f"mu{i}.{k}": v for k, v in o.mu.items()})
        for k, v in o.nu.items():  # a factored leaf as its r and c
            out.update({f"nu{i}.{k}.{f}": t for f, t in v.items()} if isinstance(v, dict)
                       else {f"nu{i}.{k}": v})
    return out


def _assert_bitwise(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _v4(cfg, data):
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
    train_epoch, _ = make_epoch_fns(mods, cfg)
    state, m = train_epoch(state, data["x"], data["y"], data["perm"],
                           (data["z0"], data["alphas"]))
    return m, _state(mods, (state.opt_g, state.opt_d)), state


# --- the decoder reads its copy ------------------------------------------------------------

def test_dense_reads_the_copy_bitwise():
    """The CPU route with the copy: the same output, and the copy's bf16
    gradient upcast is the master's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 40, generator=g).to(BF16)
    w = torch.randn(24, 40, generator=g) / 7
    b = torch.randn(24, generator=g)
    cot = torch.randn(6, 24, generator=g).to(BF16)
    outs = []
    for cached in (False, True):
        xx, ww, bb = (t.clone().requires_grad_() for t in (x, w, b))
        w16 = ww.detach().to(BF16).requires_grad_() if cached else None
        y = dense(xx, ww, bb, BF16, w16)
        y.backward(cot)
        gw = w16.grad.float() if cached else ww.grad
        assert cached or w16 is None
        outs.append((y, xx.grad, gw, bb.grad))
        if cached:
            assert ww.grad is None and w16.grad.dtype == BF16
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cached", [False, True], ids=["master", "copy"])
def test_bf16_dense_function_matches_the_cpu_route(x_dtype, cached):
    """``Bf16Dense`` (the card's route; here ``mm_bf16``'s CPU GEMMs) against
    the CPU route: y, the input's and the bias's gradients, and the
    weight's (in the copy's dtype where the copy is read)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 64, generator=g).to(getattr(torch, x_dtype))
    w = torch.randn(96, 64, generator=g) / 8
    b = torch.randn(96, generator=g) / 8
    cot = torch.randn(2, 5, 96, generator=g).to(BF16)
    got, want = [], []
    for route, out in (("function", got), ("cpu", want)):
        xx, ww, bb = (t.clone().requires_grad_() for t in (x, w, b))
        src = ww.detach().to(BF16).requires_grad_() if cached and route == "function" else ww
        if route == "function":
            y = Bf16Dense.apply(xx, src, bb)
        else:
            y = F.linear(round_bf16(xx), round_bf16(ww), bb).to(BF16)
        y.backward(cot)
        out += [y, xx.grad, src.grad, bb.grad]
    assert got[2].dtype == (BF16 if cached else torch.float32)
    assert got[1].dtype == x.dtype and got[0].dtype == BF16
    for a, b_ in zip(got, want):
        scale = float(b_.detach().float().abs().max())
        torch.testing.assert_close(a.float(), b_.float(), rtol=0, atol=2.0**-7 * scale)


# --- whole steps: cache on against off --------------------------------------------------------

@pytest.mark.parametrize("flags", [{}, {"BF16_ADAM_NU": True},
                                   {"FUSED_POINTNET": True, "FUSED_ADAM": True},
                                   {"FUSED_POINTNET": True, "FUSED_ADAM": True,
                                    "BF16_ADAM_NU": True}],
                         ids=["bf16", "bf16_nu16", "bf16_fused", "bf16_nu16_fused"])
def test_v4_cache_on_equals_off(data, flags):
    cfg = Config(MODEL_NAME="WC_V4", COMPUTE_DTYPE="bfloat16", **DIMS, **flags)
    m_off, s_off, _ = _v4(cfg, data)
    m_on, s_on, state = _v4(cfg.replace(BF16_WEIGHT_CACHE=True), data)
    # the copies: the decoder's 5 kernels, rounded from the final masters
    assert sorted(state.cast_g) == [f"decoder.dense.{i}.weight" for i in range(5)]
    for k, w16 in state.cast_g.items():
        assert w16.dtype == BF16 and torch.equal(w16, s_on[f"m.g.{k}"].to(BF16))
    _assert_bitwise(m_on, m_off)
    _assert_bitwise(s_on, s_off)


@pytest.mark.parametrize("flags", [{}, {"FACTORED_ADAM_NU": True}], ids=["bf16", "bf16_factored"])
def test_orced_cache_on_equals_off(data, flags):
    outs = []
    for cache in (False, True):
        cfg = Config(MODEL_NAME="WC_ORCED", COMPUTE_DTYPE="bfloat16", BF16_WEIGHT_CACHE=cache,
                     **DIMS, **flags)
        mods, state = build_orced(cfg, device="cpu")
        assert len(state.cast) == (5 if cache else 0)
        step = make_orced_train_step(mods, cfg)
        metrics = []
        for i in range(STEPS):
            idx = torch.from_numpy(data["perm"][i])
            state, m = step(state, data["x"][idx], data["y"][idx], 0.5, data["z0"][i])
            metrics.append(m)
        outs.append((metrics, _state(mods, (state.opt,))))
    for a, b in zip(outs[0][0], outs[1][0]):
        _assert_bitwise(a, b)
    _assert_bitwise(outs[0][1], outs[1][1])


# --- the Adam update writes the copy ------------------------------------------------------

def test_fused_update_writes_the_copy_as_jax_casts():
    """``fused_adam_tree_update(cache=)`` (the plain version on the CPU; the
    kernel's on the card, ``tests/test_torch_kernels_gpu.py``) against the
    JAX function and ``_cache_tree`` of its new parameters, m bf16 and m, v
    bf16: the copy of a 2-D leaf is its new weight rounded to bf16."""
    rng = np.random.default_rng(2)
    shapes = {"w": (24, 40), "b": (40,)}
    p0 = {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    for nu_dtype in (torch.float32, BF16):
        tp = {k: torch.tensor(v) for k, v in p0.items()}
        tm = {k: torch.zeros(s, dtype=BF16) for k, s in shapes.items()}
        tv = {k: torch.zeros(s, dtype=nu_dtype) for k, s in shapes.items()}
        cache = {"w": tp["w"].to(BF16)}
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jm = {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()}
        jv = {k: jnp.zeros(s, jnp.bfloat16 if nu_dtype == BF16 else jnp.float32)
              for k, s in shapes.items()}
        count = jnp.zeros([], jnp.int32)
        tcount = 0
        for _ in range(3):
            grads = {k: (rng.normal(size=s) * 0.01).astype(np.float32) for k, s in shapes.items()}
            with pltpu.force_tpu_interpret_mode():
                jp, count, jm, jv = jax_fused_adam_tree_update(
                    {k: jnp.asarray(v) for k, v in grads.items()}, count, jm, jv, jp,
                    lr=1e-3, b1=0.9, b2=0.99, use_pallas=True, min_kernel_elems=0)
            tcount = adam.fused_adam_tree_update({k: torch.tensor(v) for k, v in grads.items()},
                                                 tcount, tm, tv, tp, lr=1e-3, b1=0.9, b2=0.99,
                                                 min_kernel_elems=0, cache=cache)
        assert tcount == int(count) == 3
        assert torch.equal(cache["w"], tp["w"].to(BF16))
        jcache = jax.device_get(_cache_tree(jp))
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **ADAM_TOL)
        np.testing.assert_allclose(cache["w"].float().numpy(),
                                   np.asarray(jcache["w"], np.float32), rtol=2.0**-7, atol=0)
        assert jcache["b"].shape == (0,)  # JAX's placeholder: biases are not copied


# --- the grid and the refusals ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["pcaa", "orced"])
def test_grid_with_the_cache_is_the_solo_runs(tmp_path, kind):
    """Two runs of a grid with ``BF16_WEIGHT_CACHE`` (each its solo state,
    ``parallel/grid.py``) against the same runs alone, one epoch: bitwise."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 12, 48, 4)).astype(np.float32)
    y = (np.arange(16) % 3).astype(np.int32)
    cfgs = [Config(MODEL_NAME=f"WG{r}_V4", MODELS_PATH=str(tmp_path), SEED=r,
                   COMPUTE_DTYPE="bfloat16", BF16_WEIGHT_CACHE=True, **DIMS) for r in range(2)]
    if kind == "pcaa":
        trainer = GridPCAATrainer(cfgs, VARIATION.V4, [(x, y)] * 2, device="cpu")
        trainer.run_epoch(0)
    else:
        trainer = GridORCEDTrainer(cfgs, [(x, y)] * 2, device="cpu")
        trainer.run_epoch(0)
    for r, cfg in enumerate(cfgs):
        if kind == "pcaa":
            mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
            train_epoch, _ = make_epoch_fns(mods, cfg)
            opts = lambda s: (s.opt_g, s.opt_d)  # noqa: E731
            cache = state.cast_g
        else:
            mods, state = build_orced(cfg, device="cpu")
            train_epoch, _ = make_orced_epoch_fns(mods, cfg)
            opts = lambda s: (s.opt,)  # noqa: E731
            cache = state.cast
        perm = epoch_batch_indices(16, 8, True, rng=np.random.default_rng(cfg.SEED))
        args = () if kind == "pcaa" else (0.0,)
        state, _ = train_epoch(state, torch.from_numpy(x), torch.from_numpy(y), perm, *args)
        g_mods, g_state = trainer.per_run_states()[r]
        assert len(cache) == 5
        _assert_bitwise(_state(g_mods, opts(g_state)), _state(mods, opts(state)))


@pytest.mark.parametrize("variation,flags,match", [
    (VARIATION.V4, {}, "would CHANGE numerics"),
    (VARIATION.V3, {"COMPUTE_DTYPE": "bfloat16"}, "targets the decoder"),
], ids=["f32_compute", "no_decoder"])
def test_jax_refusals(variation, flags, match):
    cfg = Config(MODEL_NAME="WR_V4", BF16_WEIGHT_CACHE=True, **DIMS, **flags)
    with pytest.raises(ValueError, match=match):
        build_pcaa(cfg, VARIANTS[variation], device="cpu")
    if variation == VARIATION.V4:
        with pytest.raises(ValueError, match="would CHANGE numerics"):
            build_orced(cfg, device="cpu")


def test_train_step_reads_the_copies_it_was_built_with(data):
    """A step differentiates w.r.t. the copies: their bf16 gradients reach
    Adam upcast, and the masters' own ``grad`` stays unset."""
    cfg = Config(MODEL_NAME="WS_V4", COMPUTE_DTYPE="bfloat16", BF16_WEIGHT_CACHE=True, **DIMS)
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cpu")
    before = {k: v.clone() for k, v in state.cast_g.items()}
    step = make_train_step(mods, cfg)
    idx = torch.from_numpy(data["perm"][0])
    step(state, data["x"][idx], data["y"][idx], 0, (data["z0"][0], data["alphas"][0]))
    for k, w16 in state.cast_g.items():
        layer = mods.g.get_submodule(k.rsplit(".", 1)[0])
        assert layer.weight_bf16 is w16 and layer.weight.grad is None
        assert not torch.equal(w16, before[k])  # refreshed from the stepped master
        assert torch.equal(w16, layer.weight.detach().to(BF16))


def test_cache_follows_its_shards_under_tensor_parallelism():
    """MP 2 (the decoder's kernels sharded on their output rows; the Adam
    kernel's wrapper on the CPU writes each shard's copy): one step with
    the cache and one without, bitwise; the gathered state is whole."""
    rng = np.random.default_rng(6)
    data = dict(x=rng.normal(size=(8, 12, 48, 4)).astype(np.float32),
                y=(np.arange(8) % 3).astype(np.int32), perm=np.arange(8)[None],
                z0=rng.normal(size=(1, 8, 16)).astype(np.float32),
                alphas=rng.uniform(size=(1, 8, 1)).astype(np.float32))
    cfg = Config(MODEL_NAME="WM_V4", COMPUTE_DTYPE="bfloat16", FUSED_ADAM=True, MP_DEVICES=2,
                 MP_MIN_DIM=16, **DIMS)
    runs = [launch(pcaa_steps, 2, cfg.replace(BF16_WEIGHT_CACHE=cache), VARIATION.V4, None,
                   data, backend="gloo") for cache in (False, True)]
    for k in runs[0]["metrics"]:
        np.testing.assert_array_equal(runs[1]["metrics"][k], runs[0]["metrics"][k], err_msg=k)
    off, on = runs[0]["state"], runs[1]["state"]
    assert on["modules"]["g.decoder.dense.4.weight"].shape == (2304, 1152)
    for k, v in off["modules"].items():
        np.testing.assert_array_equal(on["modules"][k], v, err_msg=k)
    for side in ("opt_g", "opt_d"):
        for moment in ("mu", "nu"):
            for k, v in off[side][moment].items():
                a, b = on[side][moment][k], v
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (side, moment, k)
