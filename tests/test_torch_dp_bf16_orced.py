"""The port's bf16 + nu16 PCAA step and OR-CED step at DP 2 × MP 2 against
the JAX package's sharded step and the port's single-device step, on the
CPU, as ``tests/test_torch_dp.py`` holds the f32 V4 step (its set-up, dims
and f32 tolerances).

Tolerances of bf16 + nu16: the losses rtol 2e-3 and Adam's moments in L1
over a side within 5e-2 (the generator) and 5e-3 (the critic),
``tests/test_torch_bf16_train.py``'s bounds for two bf16 steps that round
at the same places and sum in other orders. The OR-CED step (the triplet
loss over the all-gathered global pair grid, the KL term at ``kl_mult``
0.5, the mean learner's global BatchNorm) takes the f32 bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from opensetgaitrecognition_pcaa_tpu.config import Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.parallel import batch_sharding, create_mesh, state_shardings
from opensetgaitrecognition_pcaa_tpu.train.orced import (
    build_orced as jax_build_orced,
    make_orced_train_step as jax_make_orced_train_step,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import Config
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch
from tests.test_torch_dp import (
    DIMS,
    LOSS_KEYS,
    _assert_moments,
    _data,
    _opt_tree,
    _pcaa_case,
    _zero_grad,
    one_thread,  # noqa: F401 (the module's autouse fixture)
)
from tests.torch_ranks import orced_steps

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

ORCED_KEYS = ("rec_loss", "sup_loss", "trip_loss", "kl_loss", "tot_loss")
KL_MULT = 0.5  # epoch 0 has no KL term; a step of a later epoch has one


def _jax_orced(cfg, dp, mp):
    models, state = jax_build_orced(cfg, jax.random.PRNGKey(0))
    tree = jax.device_get({"params": state.params, "batch_stats": state.batch_stats,
                           "opt": _opt_tree(state.opt)})
    data = _data(cfg, orced=True)
    mesh = create_mesh(dp * mp, model_parallel=mp)
    st_sh = state_shardings(state, mesh, min_dim=cfg.MP_MIN_DIM)
    rows, whole = batch_sharding(mesh), NamedSharding(mesh, P())
    step = jax.jit(jax_make_orced_train_step(models, cfg),
                   in_shardings=(st_sh, rows, rows, whole, whole, rows),
                   out_shardings=(st_sh, None))
    put = jax.device_put
    _, m = step(jax.tree_util.tree_map(put, state, st_sh), put(data["x"], rows),
                put(data["y"], rows), put(jnp.int32(0), whole), put(jnp.float32(KL_MULT), whole),
                put(data["eps"][0], rows))
    return tree, jax.device_get(m)


def _side_l1(got, want):
    num = sum(float(np.abs(np.asarray(got[k], np.float32) - np.asarray(w, np.float32)).sum())
              for k, w in want.items() if not _zero_grad(k))
    den = sum(float(np.abs(np.asarray(w, np.float32)).sum())
              for k, w in want.items() if not _zero_grad(k))
    return num / den


def test_bf16_nu16_step_matches_jax_sharded_step_and_the_single_device_port():
    jax_m, solo, sharded = _pcaa_case("dp2_mp2", COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True)
    got = sharded["metrics"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k][0], jax_m[k], rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], solo["metrics"][k], rtol=2e-3, atol=0, err_msg=k)
    assert got["n_correct"][0] == jax_m["n_correct"] == solo["metrics"]["n_correct"][0]
    for side, bound in (("opt_g", 5e-2), ("opt_d", 5e-3)):
        for part in ("mu", "nu"):
            leaves = sharded["state"][side][part]
            assert all(v.dtype == torch.bfloat16 for v in leaves.values()), (side, part)
            gap = _side_l1({k: v.float().numpy() for k, v in leaves.items()},
                           {k: v.float().numpy() for k, v in solo["state"][side][part].items()})
            assert gap < bound, (side, part, gap)



def test_orced_step_matches_jax_sharded_step_and_the_single_device_port():
    """The triplet loss over the gathered global pair grid, the KL term
    (``kl_mult`` 0.5) and the mean learner's global BatchNorm."""
    cfg = JaxConfig(MODEL_NAME="DP_ORCED", **DIMS)
    tree, jax_m = _jax_orced(cfg, 2, 2)
    pcfg = Config.from_dict(cfg.to_dict())
    data = _data(cfg, orced=True)
    solo = orced_steps(pcfg, tree, data, KL_MULT)
    sharded = launch(orced_steps, 4, pcfg.replace(DP_DEVICES=2, MP_DEVICES=2), tree, data,
                     KL_MULT, backend="gloo")
    got = sharded["metrics"]
    for k in ORCED_KEYS:
        np.testing.assert_allclose(got[k][0], jax_m[k], rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], solo["metrics"][k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert got["trip_loss"][0] > 0 and got["kl_loss"][0] != 0
    assert got["n_correct"][0] == jax_m["n_correct"] == solo["metrics"]["n_correct"][0]
    _assert_moments(sharded["state"]["opt"]["mu"], solo["state"]["opt"]["mu"])
