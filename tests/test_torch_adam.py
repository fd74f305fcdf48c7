"""The port's Adam against the JAX package's, on the CPU.

- ``ops/adam.py::fused_adam_tree_update`` against the JAX function with its
  Pallas kernel in interpret mode (``use_pallas=True``,
  ``min_kernel_elems=0``), on a 136×648 leaf and a bias leaf, over 3 steps;
- ``train/optim.py::adam_update_`` (and the fused update) against
  ``optax.adam`` over 5 steps.

Tolerance rtol 1e-6, atol 1e-9: the same f32 formula on both sides; the
bias corrections ``b^t`` come from numpy's ``powf`` here and XLA's there,
and may differ in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensetgaitrecognition_pcaa_tpu.ops.pallas.adam_kernel import (
    fused_adam_tree_update as jax_fused_adam_tree_update,
)

from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import adam_init, adam_update_

TOL = dict(rtol=1e-6, atol=1e-9)
LR, B1, B2 = 1e-4, 0.9, 0.99
SHAPES = {"kernel": (136, 648), "bias": (648,)}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (1e-2 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_fused_update_matches_the_jax_kernel():
    params = _leaves(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {k: jnp.zeros_like(v) for k, v in jp.items()}
    jv = {k: jnp.zeros_like(v) for k, v in jp.items()}
    count = jnp.zeros([], jnp.int32)
    tp, tm, tv = _torch(params), {k: torch.zeros(s) for k, s in SHAPES.items()}, \
        {k: torch.zeros(s) for k, s in SHAPES.items()}
    tcount = 0
    before = adam.adam_update_.launches
    for step in range(3):
        g = _grads(step)
        with pltpu.force_tpu_interpret_mode():
            jp, count, jm, jv = jax_fused_adam_tree_update(
                {k: jnp.asarray(v) for k, v in g.items()}, count, jm, jv, jp,
                lr=LR, b1=B1, b2=B2, use_pallas=True, min_kernel_elems=0,
            )
        tcount = adam.fused_adam_tree_update(_torch(g), tcount, tm, tv, tp, lr=LR, b1=B1, b2=B2,
                                             min_kernel_elems=0)
    assert tcount == int(count) == 3
    assert adam.adam_update_.launches == before  # CPU tensors: the plain version
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["optim", "fused"])
def test_matches_optax_adam(fused):
    params = _leaves(1)
    tx = optax.adam(LR, b1=B1, b2=B2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    tp = _torch(params)
    state = adam_init(tp.items())
    for step in range(5):
        g = _grads(step)
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        if fused:
            state.count = adam.fused_adam_tree_update(_torch(g), state.count, state.mu, state.nu,
                                                      tp, lr=LR, b1=B1, b2=B2)
        else:
            adam_update_(state, tp, _torch(g), lr=LR, b1=B1, b2=B2)
    assert state.count == int(opt[0].count) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(opt[0].mu[k]), **TOL)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(opt[0].nu[k]), **TOL)


def test_scalars_are_f32_bias_corrections():
    s1, s2 = adam.adam_scalars(3, LR, B1, B2)
    t = jnp.float32(3)
    np.testing.assert_allclose(s1, float(LR / (1.0 - B1**t)), rtol=1e-7)
    np.testing.assert_allclose(s2, float(1.0 / (1.0 - B2**t)), rtol=1e-7)


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda g, w, m, v: (g.double(), w, m, v), "float32"),
        (lambda g, w, m, v: (g, w.t(), m, v), "contiguous"),
        (lambda g, w, m, v: (g, w, m[:, :-1].contiguous(), v), "shape"),
        (lambda g, w, m, v: (g.flatten()[1:], w.flatten()[1:], m.flatten()[1:],
                             v.flatten()[1:]), "aligned"),
    ],
    ids=["dtype", "contiguity", "shape", "alignment"],
)
def test_argument_checks(mutate, match):
    leaf = [torch.zeros(8, 8) for _ in range(4)]
    with pytest.raises(ValueError, match=match):
        adam._check_cuda_args(*mutate(*leaf))


def test_no_kernel_for_other_devices():
    leaf = [torch.zeros(8, 8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel"):
        adam.adam_update_(*leaf, s1=1.0, s2=1.0, b1=B1, b2=B2, eps=1e-8)
