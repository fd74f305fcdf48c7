"""The bf16 variants of the kernels' functions, plain versions on the CPU,
against the JAX package's; and the run-folder codec's bf16 arrays.

- ``ops/pointnet_train.py::pointnet_pool_train(..., torch.bfloat16)``
  against JAX ``pointnet_pool_train(..., store_dtype=bf16)`` (its Pallas
  kernels in interpret mode) at 256 rows (one of its 256-row tiles: no
  padding rows) with D = 16, and at 222 rows with
  NFEATURES 5 and D 30 (padded rows and widths);
- Adam with bf16 moments: ``ops/adam.py::fused_adam_tree_update`` against
  JAX ``fused_adam_tree_update`` (interpret mode) and
  ``train/optim.py::adam_update_`` against ``adam_lowmem`` and
  ``optax.adam(mu_dtype=bf16)``, 5 steps each.

Tolerances and their reasons:

- PointNet without padding rows: the same bf16 roundings on both sides,
  the f32 sums between them in other orders, so a rounded value may sit
  one bf16 step away and move what follows, rarely: forward outputs rtol
  1e-3, atol 1e-4 of the largest magnitude (measured: 1e-7). In the
  backward the rounding of g_y to bf16 for wgrad and dgrad flips an
  element where its f32 value sits on a boundary, and a dgrad over few
  channels cancels: gradients rtol 1e-2, atol 1e-2 of the largest
  magnitude;
- PointNet at 222 rows: the TPU kernel pads the rows to its 256-row tile
  and subtracts the padding rows' share of the sums computed in f32
  (``_stats_from_sums``), while under bf16 those rows went through the
  bf16 roundings: JAX's statistics are off by about (34/222)·2^-8 of a
  value (measured 3e-4 in a mean), which normalization carries into every
  output (ROADMAP.md Queue 3). The port masks the ragged rows and has no
  such term. rtol 1e-2, atol 1e-2 of the largest magnitude there, forward
  and backward;
- either case: the port's bf16 output at least twice as close to JAX's
  bf16 output as to JAX's f32 output (at 222 rows JAX's padding term is
  about a third of the bf16 - f32 difference); a dense bias ahead of a
  train-mode BatchNorm has a zero gradient, held to atol 1e-4 of the
  largest W gradient without padding rows and to the atol above with
  them (JAX's off statistics leave it a share of the gradient);
- Adam: the same f32 formula with the moments rounded at the store, so the
  stored moments are within one bf16 step, and the parameters within rtol
  1e-6 (the bias corrections ``b^t`` come from numpy's ``powf`` here and
  XLA's there) plus atol lr·2^-8: where a stored moment lands one bf16
  step away, the next update (at most about lr) moves by that share.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.models.layers import PointNetBlock
from opensetgaitrecognition_pcaa_tpu.ops.pallas.adam_kernel import (
    fused_adam_tree_update as jax_fused_adam_tree_update,
)
from opensetgaitrecognition_pcaa_tpu.ops.pallas.pointnet_train import (
    pointnet_pool_train as jax_pointnet_pool_train,
)
from opensetgaitrecognition_pcaa_tpu.train.optim import adam_lowmem

from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt
from opensetgaitrecognition_pcaa_tpu_torch.train import run_folder
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import adam_init, adam_update_

BF16 = torch.bfloat16

torch.set_num_threads(1)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# --- the train-mode PointNet at bf16 ------------------------------------------

@pytest.fixture(scope="module", params=[((2, 4, 32, 4), 16, 1e-3, 1e-4),
                                        ((2, 3, 37, 5), 30, 1e-2, 1e-2)],
                ids=["rows256_c4_d16", "rows222_c5_d30"])
def case(request):
    """→ (x, layers, cotangent, (rtol, atol fraction))."""
    (b, t, n, c), d, rtol, atol = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, n, c)).astype(np.float32)
    variables = PointNetBlock(out_dim=d).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    p = jax.device_get(variables["params"])
    r2 = np.random.default_rng(1)
    layers = []
    for i in range(4):
        dense = p[f"TorchDense_{i}"]
        c_out = dense["bias"].shape[0]
        layers.append((
            np.asarray(dense["kernel"]), np.asarray(dense["bias"]),
            (1.0 + 0.2 * r2.normal(size=c_out)).astype(np.float32),
            (0.1 * r2.normal(size=c_out)).astype(np.float32),
        ))
    cot = np.random.default_rng(2).normal(size=(b, t, d)).astype(np.float32)
    return x, tuple(layers), cot, (rtol, atol)


def _torch_params(layers, requires_grad=False):
    return tuple(
        tuple(torch.tensor(a, requires_grad=requires_grad) for a in layer) for layer in layers
    )


def _close(got, want, rtol, atol_frac, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()) + 1e-12, err_msg=what)


def test_forward_matches_jax_bf16(case):
    x, layers, _, tol = case
    b, t, n, _ = x.shape
    jl = jax.tree_util.tree_map(jnp.asarray, layers)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pointnet_pool_train(jnp.asarray(x), jl, b, t, n, jnp.bfloat16)
        want32 = jax_pointnet_pool_train(jnp.asarray(x), jl, b, t, n)
    got = pt.pointnet_pool_train(torch.from_numpy(x), _torch_params(layers), BF16)
    assert got[0].dtype == torch.float32
    _close(got[0].numpy(), want[0], *tol, "pooled")
    for i in range(4):
        _close(got[1][i].numpy(), want[1][i], *tol, f"mean {i}")
        _close(got[2][i].numpy(), want[2][i], *tol, f"var {i}")
    # the bf16 path is taken: closer to JAX's bf16 output than to its f32 one
    d_bf16 = np.abs(got[0].numpy() - np.asarray(want[0])).max()
    d_f32 = np.abs(got[0].numpy() - np.asarray(want32[0])).max()
    assert d_bf16 * 2 < d_f32, (d_bf16, d_f32)


def test_the_plain_layer_rounds_where_the_tpu_kernel_does():
    """y is the bf16 rounding of an f32 sum of bf16 products plus the f32
    bias; the statistics come from the unrounded sum."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(50, 24)).astype(np.float32)).to(BF16)
    affine = torch.from_numpy(np.stack([rng.normal(0, 0.5, 24), rng.uniform(0.5, 2, 24),
                                        rng.normal(0, 0.3, 24)]).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    y, mean, var = pt.fused_layer(h, affine, w, b)
    a = torch.nn.functional.elu((h.float() - affine[0]) * affine[1] + affine[2])
    y32 = a.to(BF16).double() @ w.to(BF16).double() + b.double()
    assert y.dtype == BF16
    assert torch.equal(y, y32.float().to(BF16))
    torch.testing.assert_close(mean, y32.mean(0).float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, y32.var(0, unbiased=False).float(), rtol=1e-5, atol=1e-6)


def test_gradients_match_jax_bf16(case):
    x, layers, cot, _ = case
    tol = (1e-2, 1e-2)
    b, t, n, _ = x.shape

    def loss(params, xx, dtype):
        pooled, _, _ = jax_pointnet_pool_train(xx, params, b, t, n, dtype)
        return jnp.sum(pooled * cot)

    jl = jax.tree_util.tree_map(jnp.asarray, layers)
    with pltpu.force_tpu_interpret_mode():
        want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x), jnp.bfloat16)
        f32_gp, _ = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x), jnp.float32)
    params = _torch_params(layers, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    pooled, _, _ = pt.pointnet_pool_train(xt, params, BF16)
    torch.sum(pooled * torch.from_numpy(cot)).backward()
    assert xt.grad.dtype == torch.float32
    _close(xt.grad.numpy(), want_gx, *tol, "x")
    d_bf16 = d_f32 = 0.0
    for i, names in enumerate(params):
        for j, name in enumerate(("W", "b", "gamma", "beta")):
            got = names[j].grad.numpy()
            if name == "b":
                scale = float(np.abs(np.asarray(want_gp[i][0])).max())
                padded = x.shape[0] * x.shape[1] * x.shape[2] % 256
                np.testing.assert_allclose(got, np.asarray(want_gp[i][j]), rtol=0,
                                           atol=(tol[1] if padded else 1e-4) * scale,
                                           err_msg=f"b{i}")
                continue
            _close(got, want_gp[i][j], *tol, f"{name}{i}")
            if name == "W":
                d_bf16 = max(d_bf16, np.abs(got - np.asarray(want_gp[i][j])).max())
                d_f32 = max(d_f32, np.abs(got - np.asarray(f32_gp[i][j])).max())
    assert d_bf16 * 2 < d_f32, (d_bf16, d_f32)


def test_store_dtype_is_checked(case):
    x, layers, _, _ = case
    with pytest.raises(ValueError, match="store_dtype"):
        pt.pointnet_pool_train(torch.from_numpy(x), _torch_params(layers), torch.float16)


def test_bf16_padding_to_multiples_of_8():
    h = torch.zeros(3, 5, dtype=BF16)
    affine = torch.ones(3, 5)
    w, b = torch.ones(5, 30), torch.ones(30)
    hp, ap, wp, bp = pt.pad_layer(h, affine, w, b, multiple=8)
    assert hp.shape == (3, 8) and hp.dtype == BF16 and ap.shape == (3, 8)
    assert wp.shape == (8, 32) and bp.shape == (32,)
    assert not ap[:, 5:].any() and not wp[5:].any() and not wp[:, 30:].any()


# --- Adam with bf16 moments --------------------------------------------------

LR, B1, B2 = 1e-4, 0.9, 0.99
W_TOL = dict(rtol=1e-6, atol=LR * 2.0**-8)
SHAPES = {"kernel": (136, 648), "bias": (648,)}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (1e-2 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _assert_moment(got: torch.Tensor, want, what):
    assert got.dtype == BF16, what
    want = np.asarray(jnp.asarray(want, jnp.float32))
    bad = np.abs(got.float().numpy() - want) > bf16_ulp(want)
    assert not bad.any(), (what, int(bad.sum()))


@pytest.mark.parametrize("nu16", [False, True], ids=["m16", "mv16"])
def test_fused_update_bf16_moments_matches_the_jax_kernel(nu16):
    params = _leaves(0)
    nu_dtype = jnp.bfloat16 if nu16 else jnp.float32
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in jp.items()}
    jv = {k: jnp.zeros(v.shape, nu_dtype) for k, v in jp.items()}
    count = jnp.zeros([], jnp.int32)
    tp = _torch(params)
    tm = {k: torch.zeros(s, dtype=BF16) for k, s in SHAPES.items()}
    tv = {k: torch.zeros(s, dtype=BF16 if nu16 else torch.float32) for k, s in SHAPES.items()}
    tcount = 0
    before = (adam.adam_update_.launches_m16, adam.adam_update_.launches_mv16)
    for step in range(5):
        g = _grads(step)
        with pltpu.force_tpu_interpret_mode():
            jp, count, jm, jv = jax_fused_adam_tree_update(
                {k: jnp.asarray(v) for k, v in g.items()}, count, jm, jv, jp,
                lr=LR, b1=B1, b2=B2, use_pallas=True, min_kernel_elems=0,
            )
        tcount = adam.fused_adam_tree_update(_torch(g), tcount, tm, tv, tp, lr=LR, b1=B1, b2=B2,
                                             min_kernel_elems=0)
    assert tcount == int(count) == 5
    assert (adam.adam_update_.launches_m16, adam.adam_update_.launches_mv16) == before
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **W_TOL)
        _assert_moment(tm[k], jm[k], f"mu {k}")
        if nu16:
            _assert_moment(tv[k], jv[k], f"nu {k}")
        else:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("flavor", ["optax_mu16", "lowmem_m16", "lowmem_mv16"])
def test_adam_update_bf16_matches_jax(flavor):
    """``adam_update_`` with bf16 moments against the JAX package's two
    optimizers at bf16: ``optax.adam(mu_dtype=bf16)`` (b1 rounded to bf16
    in ``b1·mu``: ``optax_mu``) and ``adam_lowmem`` (upcast first)."""
    params = _leaves(1)
    nu16 = flavor == "lowmem_mv16"
    if flavor == "optax_mu16":
        tx = optax.adam(LR, b1=B1, b2=B2, mu_dtype=jnp.bfloat16)
    else:
        tx = adam_lowmem(LR, b1=B1, b2=B2, mu_dtype=jnp.bfloat16,
                         nu_dtype=jnp.bfloat16 if nu16 else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    update = jax.jit(tx.update)
    tp = _torch(params)
    state = adam_init(tp.items(), mu_dtype=BF16, nu_dtype=BF16 if nu16 else torch.float32,
                      optax_mu=flavor == "optax_mu16")
    for step in range(5):
        g = _grads(step)
        upd, opt = update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        adam_update_(state, tp, _torch(g), lr=LR, b1=B1, b2=B2)
    assert state.count == int(opt[0].count) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **W_TOL, err_msg=k)
        _assert_moment(state.mu[k], opt[0].mu[k], f"mu {k}")
        if nu16:
            _assert_moment(state.nu[k], opt[0].nu[k], f"nu {k}")
        else:
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(opt[0].nu[k]),
                                       rtol=1e-6, atol=1e-12)


def test_optax_mu_rounds_b1_to_bf16():
    """The quirk ``optax_mu`` keeps: after one step from mu = 1, the stored
    first moment is 0.8984375·1 + 0.1·g, not 0.9·1 + 0.1·g."""
    w = {"w": torch.zeros(4)}
    g = {"w": torch.zeros(4)}
    for optax_mu, want in ((True, 0.8984375), (False, 0.8984375 + 0.0009765625)):
        state = adam_init(w.items(), mu_dtype=BF16, optax_mu=optax_mu)
        state.mu["w"].fill_(1.0)
        adam_update_(state, {"w": w["w"].clone()}, g, lr=LR, b1=B1, b2=B2)
        # 0.9 itself rounds to 0.8984375 or 0.90234375 in bf16
        assert float(state.mu["w"][0]) in (want, 0.8984375, 0.90234375)
    state = adam_init(w.items(), mu_dtype=BF16, optax_mu=True)
    state.mu["w"].fill_(1.0)
    adam_update_(state, {"w": w["w"].clone()}, g, lr=LR, b1=B1, b2=B2)
    assert float(state.mu["w"][0]) == 0.8984375


def test_bf16_moments_argument_checks():
    """Every (m, v) pair of f32 and bf16 has a kernel, f32 m with bf16 v
    (JAX ``build_pcaa``'s moments at f32 with ``BF16_ADAM_NU``) among
    them; another moment type has none."""
    g = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="no kernel for moments"):
        adam._check_cuda_args(g, g, g, g.to(torch.float16))
    adam._check_cuda_args(g, g, g, g.to(BF16))
    adam._check_cuda_args(g, g, g.to(BF16), g)
    adam._check_cuda_args(g, g, g.to(BF16), g.to(BF16))


# --- the run-folder codec's bf16 arrays ---------------------------------------

def test_codec_round_trips_bf16(tmp_path):
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)).to(BF16)
    tree = {"opt": {"mu": {"w": t, "s": t[0, 0].clone()}, "count": np.asarray(3, np.int64)},
            "f": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = str(tmp_path / "state.msgpack")
    run_folder.save_train_state(tree, 0, {}, path)
    back, _, _ = run_folder.load_train_state(path)
    assert back["opt"]["mu"]["w"].dtype == BF16
    assert torch.equal(back["opt"]["mu"]["w"], t)
    assert torch.equal(back["opt"]["mu"]["s"], t[0, 0])
    np.testing.assert_array_equal(back["f"], tree["f"])


def test_codec_reads_flax_bf16_bits_and_writes_flax_bytes(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(3, 11)).astype(np.float32).astype(ml_dtypes.bfloat16)
    tree = {"params": {"kernel": arr, "bias": np.ones(11, np.float32)}}
    raw = flax.serialization.msgpack_serialize(tree)
    path = str(tmp_path / "flax.msgpack")
    with open(path, "wb") as f:
        f.write(raw)
    got = run_folder.load_params(path)
    assert got["params"]["kernel"].dtype == BF16
    np.testing.assert_array_equal(got["params"]["kernel"].view(torch.int16).numpy(),
                                  arr.view(np.int16))
    out = str(tmp_path / "port.msgpack")
    run_folder.save_params({"params": {"kernel": got["params"]["kernel"],
                                       "bias": got["params"]["bias"]}}, out)
    with open(out, "rb") as f:
        assert f.read() == raw
    assert os.path.getsize(out) == len(raw)
