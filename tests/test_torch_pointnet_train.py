"""The port's train-mode PointNet + pool against the JAX package's
``pointnet_pool_train`` (its Pallas kernels in interpret mode), on the CPU.

The setup of ``tests/test_pointnet_train_kernel.py``: x of (2, 3, 37, 4)
(222 rows, not a multiple of any tile), D = 16, flax init with the
BatchNorm affine perturbed. Tolerances: outputs rtol 1e-5, atol 1e-6, as
for two f32 implementations that sum in different orders; gradients rtol
1e-4, atol 1e-6, since the backward adds the rounding of the recomputed
normalize + ELU and of four matmul VJPs on top. A dense bias ahead of a
train-mode BatchNorm has a zero gradient (the batch mean removes it): both
sides return rounding noise of about 1e-6 there, from sums over 222 rows,
so those gradients are held to atol 5e-6 instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.models.layers import PointNetBlock
from opensetgaitrecognition_pcaa_tpu.ops.pallas.pointnet_train import (
    pointnet_pool_train as jax_pointnet_pool_train,
)

from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BIAS_TOL = dict(rtol=0, atol=5e-6)
B, T, N, C, D = 2, 3, 37, 4, 16


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, N, C)).astype(np.float32)
    variables = PointNetBlock(out_dim=D).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
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
    cot = np.random.default_rng(2).normal(size=(B, T, D)).astype(np.float32)
    return x, tuple(layers), cot


def _torch_params(layers, requires_grad=False):
    return tuple(
        tuple(torch.tensor(a, requires_grad=requires_grad) for a in layer) for layer in layers
    )


def test_forward_matches_jax(case):
    x, layers, _ = case
    with pltpu.force_tpu_interpret_mode():
        want = jax_pointnet_pool_train(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, layers),
                                       B, T, N)
    got = pt.pointnet_pool_train(torch.from_numpy(x), _torch_params(layers))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **OUT_TOL)
    for i in range(4):
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1][i]), **OUT_TOL,
                                   err_msg=f"mean {i}")
        np.testing.assert_allclose(got[2][i].numpy(), np.asarray(want[2][i]), **OUT_TOL,
                                   err_msg=f"var {i}")


def test_gradients_match_jax(case):
    x, layers, cot = case

    def loss(params, xx):
        pooled, _, _ = jax_pointnet_pool_train(xx, params, B, T, N)
        return jnp.sum(pooled * cot)

    with pltpu.force_tpu_interpret_mode():
        want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x)
        )
    params = _torch_params(layers, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    pooled, _, _ = pt.pointnet_pool_train(xt, params)
    torch.sum(pooled * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **GRAD_TOL)
    for i, names in enumerate(params):
        for j, name in enumerate(("W", "b", "gamma", "beta")):
            np.testing.assert_allclose(names[j].grad.numpy(), np.asarray(want_gp[i][j]),
                                       **(BIAS_TOL if name == "b" else GRAD_TOL),
                                       err_msg=f"{name}{i}")


def test_backward_matches_autograd_of_the_plain_version(case):
    """The hand-written backward against autograd through
    ``pointnet_pool_train_ref`` (same tolerance as against JAX)."""
    x, layers, cot = case
    grads = []
    for fn in (pt.pointnet_pool_train, pt.pointnet_pool_train_ref):
        params = _torch_params(layers, requires_grad=True)
        xt = torch.tensor(x, requires_grad=True)
        pooled, _, _ = fn(xt, params)
        torch.sum(pooled * torch.from_numpy(cot)).backward()
        grads.append([("x", xt.grad)] + [(name, p.grad) for layer in params
                                         for name, p in zip(("W", "b", "gamma", "beta"), layer)])
    for (name, got), (_, want) in zip(*grads):
        tol = BIAS_TOL if name == "b" else GRAD_TOL
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_cpu_takes_the_plain_version_and_counts_nothing(case):
    x, layers, _ = case
    before = (pt.fused_layer.launches, pt.fused_pool.launches)
    got = pt.pointnet_pool_train(torch.from_numpy(x), _torch_params(layers))
    want = pt.pointnet_pool_train_ref(torch.from_numpy(x), _torch_params(layers))
    assert (pt.fused_layer.launches, pt.fused_pool.launches) == before
    for g, w in zip((got[0], *got[1], *got[2]), (want[0], *want[1], *want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _layer_args(c_in=8, c_out=16, rows=10):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(rows, c_in, generator=g), torch.randn(3, c_in, generator=g),
            torch.randn(c_in, c_out, generator=g), torch.randn(c_out, generator=g))


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda h, a, w, b: (h.double(), a, w, b), "float32"),
        (lambda h, a, w, b: (h.t().contiguous().t(), a, w, b), "contiguous"),
        (lambda h, a, w, b: (h[:, :6].contiguous(), a[:, :6].contiguous(),
                             w[:6].contiguous(), b), None),
        (lambda h, a, w, b: (h, a, w, b[:-4]), "b has shape"),
        (lambda h, a, w, b: (h, a[:2], w, b), "affine has shape"),
        (lambda h, a, w, b: (h[:0], a, w, b), "no rows"),
        (lambda h, a, w, b: (h[None], a, w, b), "2-D"),
    ],
    ids=["dtype", "contiguity", "width", "b_shape", "affine_shape", "no_rows", "rank"],
)
def test_layer_argument_checks(mutate, match):
    """Each bad argument raises; a width that is not a multiple of 4 passes
    (``match`` None): the wrapper pads it."""
    args = mutate(*_layer_args())
    if match is None:
        assert pt._check_layer_args(*args) == (10, 6, 16)
        return
    with pytest.raises(ValueError, match=match):
        pt._check_layer_args(*args)


def test_layer_argument_checks_accept_the_first_layer():
    h, _, w, b = _layer_args(c_in=4, c_out=512, rows=222)
    assert pt._check_layer_args(h, None, w, b) == (222, 4, 512)


def test_no_kernel_for_other_devices():
    h, a, w, b = _layer_args()
    with pytest.raises(ValueError, match="no kernel"):
        pt.fused_layer(h.to("meta"), a, w, b)
    with pytest.raises(ValueError, match="no kernel"):
        pt.fused_pool(h.reshape(2, 5, 8).to("meta"), a)
