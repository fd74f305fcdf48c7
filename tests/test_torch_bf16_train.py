"""The port's bf16 PCAA training step against the JAX package's, on the CPU.

``COMPUTE_DTYPE="bfloat16"``, with ``BF16_ADAM_NU`` off and on, and
``FUSED_POINTNET``/``FUSED_ADAM`` off and on (the JAX package's Pallas
kernels in interpret mode); and ``COMPUTE_DTYPE="float32"`` with
``BF16_ADAM_NU`` and both kernel flags on, whose Adam keeps f32 first and
bf16 second moments (JAX ``build_pcaa``'s ``adam_lowmem``), the moments
of the f32-m / bf16-v Adam kernel on the card. Per case one JAX ``build_pcaa`` state (NMAX 48,
NSTEPS 12, PointNet 64, latent 16, B 8: 4608 PointNet rows, a whole number
of the TPU kernel's 256-row tiles) is carried into the port with
``convert.pcaa_state_from_jax``, bf16 moments included; both sides take
the same three batches and the same injected noise ``(z0, alphas)``
(``SUPERVISION_FREQUENCY=2``). The port's f32 step runs from the same
state beside it.

Tolerances and their reasons. Both sides round to bf16 at the same places
and between the roundings sum f32 in other orders, so a value that sits on
a rounding boundary lands one bf16 step (2^-8) apart and moves what
follows. In the backward this is the rule, not the exception: the JAX
package's own bf16 encoder gradients, eager against ``jit`` (which keeps
some bf16 values unrounded), differ by 1.5-3% (L1 over a leaf), as much as
the port's differ from JAX's ``jit`` ones. So, measured on the CPU and
held with a margin:

- losses rtol 2e-3 (measured 2.4e-4) and equal correct counts;
- Adam's moments, L1 of the difference over L1 of JAX's, over all leaves
  of a side: the generator 5e-2 (measured 2.1e-2), the critic 5e-3
  (measured 2.5e-4); any single leaf 0.15 (measured 0.081). The dense and
  conv biases ahead of a train-mode BatchNorm have a zero gradient up to
  rounding (at bf16 the conv bias is added in bf16): their moments are
  noise, held to |mu| < 5e-3 and |nu| < 1e-5 (measured 1.0e-3, 1.0e-6);
- parameters: Adam moves each weight by about lr·sign(g), so where g is
  only noise the sides step apart by up to 2·lr a step: each parameter
  within 2·lr·steps, and the mean difference of a leaf within lr/2
  (measured 0.29·lr);
- running statistics within 1e-2 of the leaf's largest magnitude
  (measured 3.6e-3), and the means their layer's bias walk (0.1·lr·s·
  (s − 1)) on top;
- the port's bf16 step closer to JAX's bf16 step than to the port's own
  f32 step: the latents of the step's train-mode encoder forward on the
  first batch (the fused forward where the kernels are on; JAX's run op
  by op, without ``jit``'s excess precision), in L1. At these widths the
  bf16 rounding noise of the latents is nearly as large as bf16's whole
  effect (JAX's eager and ``jit`` latents differ by 0.12 in L1, JAX's
  ``jit`` and f32 ones by 0.14; the port's and JAX's eager ones by 0.12
  against the port's bf16 and f32 ones by 0.18), so no stronger ratio is
  held; the losses are no witness at all (the bf16 rounding of the
  decoder's output scatters the reconstruction loss about its f32 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.train.fused_encoder import (
    fused_train_encoder_apply as jax_fused_train_encoder_apply,
)
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
    make_train_step as jax_make_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import pcaa_state_from_jax, pcaa_state_to_jax
from opensetgaitrecognition_pcaa_tpu_torch.train.fused_encoder import fused_train_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, build_pcaa, make_train_step

DIMS = dict(NMAX=48, NSTEPS=12, CROP_STEP=4, POINTNET_OUT_DIM=64,
            DTC_FILTERS=(8, 8, 8, 8, 8, 16), SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
            BATCH_SIZE=8)
STEPS = 3
LOSS_RTOL = 2e-3
LOSS_KEYS = ("rec_loss", "d_loss", "sup_loss", "tot_loss")
# case -> (variant, BF16_ADAM_NU, kernel flags on, COMPUTE_DTYPE)
CASES = {
    "V4_bf16": (VARIATION.V4, False, False, "bfloat16"),
    "V4_bf16_nu16": (VARIATION.V4, True, False, "bfloat16"),
    "V4_bf16_fused": (VARIATION.V4, False, True, "bfloat16"),
    "V4_bf16_nu16_fused": (VARIATION.V4, True, True, "bfloat16"),
    "V3_bf16_nu16": (VARIATION.V3, True, False, "bfloat16"),
    "V3_bf16_fused": (VARIATION.V3, False, True, "bfloat16"),
    "V4_f32_nu16_fused": (VARIATION.V4, True, True, "float32"),
}
BF16_CASES = [case for case, c in CASES.items() if c[3] == "bfloat16"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(state):
    def opt(o):
        return {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}

    return jax.device_get({
        "params_g": state.params_g, "params_d": state.params_d,
        "batch_stats": state.batch_stats, "opt_g": opt(state.opt_g),
        "opt_d": opt(state.opt_d), "centroids": state.centroids,
    })


def _data(cfg):
    rng = np.random.default_rng(0)
    n = STEPS * cfg.BATCH_SIZE
    return dict(
        x=rng.normal(size=(n, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)).astype(np.float32),
        y=rng.integers(0, cfg.n_classes, n).astype(np.int32),
        perm=rng.permutation(n).reshape(STEPS, cfg.BATCH_SIZE).astype(np.int32),
        z0=rng.normal(size=(STEPS, cfg.BATCH_SIZE, cfg.SUP_LATENT_DIM)).astype(np.float32),
        alphas=rng.uniform(size=(STEPS, cfg.BATCH_SIZE, 1)).astype(np.float32),
    )


def _port_latents(pcfg, spec, tree0, x):
    """sup_fv of the step's train-mode encoder forward from ``tree0``."""
    mods, state = build_pcaa(pcfg, spec, device="cpu")
    pcaa_state_from_jax(tree0, mods, state)
    encoder = mods.g["encoder"].train()
    with torch.no_grad():
        if pcfg.FUSED_POINTNET:
            dtype = torch.bfloat16 if pcfg.COMPUTE_DTYPE == "bfloat16" else torch.float32
            return fused_train_encoder_apply(encoder, torch.from_numpy(x), dtype)[1].numpy()
        return encoder(torch.from_numpy(x))[1].numpy()


def _jax_latents(cfg, mods, state, spec, x):
    params, stats = state.params_g["encoder"], state.batch_stats["encoder"]
    if cfg.FUSED_POINTNET:
        with pltpu.force_tpu_interpret_mode():
            out = jax_fused_train_encoder_apply(params, stats, jnp.asarray(x),
                                                use_projection_head=spec.use_enc_head,
                                                store_dtype=jnp.bfloat16)
        return np.asarray(out[1])
    (_, fv), _ = mods.encoder.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
    return np.asarray(fv)


def _port_run(pcfg, spec, tree0, data):
    mods, state = build_pcaa(pcfg, spec, device="cpu")
    pcaa_state_from_jax(tree0, mods, state)
    step = make_train_step(mods, pcfg)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    metrics, trees = [], []
    for i in range(STEPS):
        idx = torch.from_numpy(data["perm"][i]).long()
        state, m = step(state, x[idx], y[idx], i,
                        (torch.from_numpy(data["z0"][i]), torch.from_numpy(data["alphas"][i])))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(pcaa_state_to_jax(mods, state))
    return metrics, trees, state


def _run(case):
    variation, nu16, fused, dtype = CASES[case]
    cfg = JaxConfig(MODEL_NAME=f"PORT_{variation.value}", SUPERVISION_FREQUENCY=2,
                    COMPUTE_DTYPE=dtype, BF16_ADAM_NU=nu16, FUSED_POINTNET=fused,
                    FUSED_ADAM=fused, **DIMS)
    jspec = JAX_VARIANTS[JAX_VARIATION(variation.value)]
    mods, state = jax_build_pcaa(cfg, jspec, jax.random.PRNGKey(0))
    tree0 = _tree(state)
    data = _data(cfg)
    x0 = data["x"][data["perm"][0]]
    latents = {"jax": _jax_latents(cfg, mods, state, jspec, x0)} if case in BF16_CASES else {}
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jax_metrics, jax_trees = [], []
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jax_make_train_step(mods, cfg))
        for i in range(STEPS):
            idx = data["perm"][i]
            state, m = step(state, x[idx], y[idx], jnp.int32(i),
                            (jnp.asarray(data["z0"][i]), jnp.asarray(data["alphas"][i])))
            jax_metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            jax_trees.append(_tree(state))
    pcfg = Config.from_dict(cfg.to_dict())
    f32_cfg = pcfg.replace(COMPUTE_DTYPE="float32", BF16_ADAM_NU=False)
    spec = VARIANTS[variation]
    if latents:
        latents["port"] = _port_latents(pcfg, spec, tree0, x0)
        latents["f32"] = _port_latents(f32_cfg, spec, tree0, x0)
    port_metrics, port_trees, pstate = _port_run(pcfg, spec, tree0, data)
    return dict(cfg=cfg, jax_metrics=jax_metrics, jax_trees=jax_trees, port_metrics=port_metrics,
                port_trees=port_trees, latents=latents, port_state=pstate)


class _Runs(dict):
    def __missing__(self, case):
        self[case] = _run(case)
        return self[case]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _losses(metrics):
    return np.array([[m[k] for k in LOSS_KEYS] for m in metrics])


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_step_by_step(runs, case):
    r = runs[case]
    got, want = _losses(r["port_metrics"]), _losses(r["jax_metrics"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    for m, w in zip(r["port_metrics"], r["jax_metrics"]):
        assert m["n_correct"] == w["n_correct"]
    if CASES[case][0] == VARIATION.V3:
        assert all(m["rec_loss"] == 0.0 for m in r["port_metrics"])


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_is_closer_to_jax_bf16_than_to_the_port_f32(runs, case):
    lat = runs[case]["latents"]
    d_jax = np.abs(lat["port"] - lat["jax"]).sum()
    d_f32 = np.abs(lat["port"] - lat["f32"]).sum()
    assert d_jax < d_f32, (d_jax, d_f32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _zero_grad(path) -> bool:
    keys = [getattr(k, "key", None) for k in path]
    return keys[-1] == "bias" and ("PointNetBlock_0" in keys and keys[-2].startswith("TorchDense")
                                   or keys[-2] == "Conv_0")


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_moments(got, want, side_l1, noise):
    num = den = 0.0
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        g, w = _f32(g), _f32(w)
        if _zero_grad(path):
            assert max(np.abs(g).max(), np.abs(w).max()) < noise, path
            continue
        d, n = np.abs(g - w).sum(), np.abs(w).sum()
        assert d <= 0.15 * n, (path, d / n)
        num, den = num + d, den + n
    assert num <= side_l1 * den, num / den


@pytest.mark.parametrize("steps", [1, STEPS], ids=["one_step", "three_steps"])
@pytest.mark.parametrize("case", list(CASES))
def test_state_matches(runs, case, steps):
    r = runs[case]
    got, want = r["port_trees"][steps - 1], r["jax_trees"][steps - 1]
    lr = r["cfg"].LR
    for side, side_l1 in (("opt_g", 5e-2), ("opt_d", 5e-3)):
        assert int(got[side]["count"]) == int(want[side]["count"]) == steps
        _assert_moments(got[side]["mu"], want[side]["mu"], side_l1, noise=5e-3)
        _assert_moments(got[side]["nu"], want[side]["nu"], side_l1, noise=1e-5)
    for part in ("params_g", "params_d"):
        for (path, g), (_, w) in zip(_leaves(got[part]), _leaves(want[part])):
            diff = np.abs(np.asarray(g) - np.asarray(w))
            assert diff.max() <= 2 * lr * steps * 1.01, (path, diff.max())
            if not _zero_grad(path):
                assert diff.mean() <= 0.5 * lr, (path, diff.mean() / lr)
    for (path, g), (_, w) in zip(_leaves(got["batch_stats"]), _leaves(want["batch_stats"])):
        w = np.asarray(w)
        atol = 1e-2 * float(np.abs(w).max())
        if getattr(path[-1], "key", None) == "mean":
            atol += 0.1 * lr * steps * (steps - 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("case", list(CASES))
def test_moments_are_stored_as_jax_stores_them(runs, case):
    """mu bf16 under bf16 compute, nu bf16 with BF16_ADAM_NU, on both sides."""
    _, nu16, fused, dtype = CASES[case]
    mu16 = dtype == "bfloat16"
    r = runs[case]
    state = r["port_state"]
    jtree = r["jax_trees"][-1]
    for opt, side in ((state.opt_g, "opt_g"), (state.opt_d, "opt_d")):
        assert all((v.dtype == torch.bfloat16) == mu16 for v in opt.mu.values())
        assert all((v.dtype == torch.bfloat16) == nu16 for v in opt.nu.values())
        assert opt.optax_mu == (not (nu16 or fused))
        assert {np.asarray(a).dtype.name for a in jax.tree_util.tree_leaves(jtree[side]["mu"])} \
            == {"bfloat16" if mu16 else "float32"}
        assert {np.asarray(a).dtype.name for a in jax.tree_util.tree_leaves(jtree[side]["nu"])} \
            == {"bfloat16" if nu16 else "float32"}
