"""The port's ``parallel/mesh.py`` against the JAX package's, on the CPU.

- ``create_mesh``: the port's ranks (processes of gloo, started by
  ``launch``) sit on JAX's ``(data, model)`` device grid, and each data and
  model group is a column and a row of it (``tests/test_parallel.py:42-47``);
- the tensor-parallel rule: for every leaf of the V4, V1 and OR-CED
  parameters, running statistics and Adam moments, at the tiny widths and
  at the published ones (shapes only: JAX ``eval_shape``, the port's
  modules on the meta device), the port's spec names the leaf and axis that
  JAX ``state_shardings`` names, at ``MP_MIN_DIM`` 128 and 16, through
  ``convert.py``'s name tables;
- ``shard_state`` of a JAX state carried by ``convert`` is, on each rank,
  JAX's own shard of each leaf; ``gather_state`` undoes ``shard_state``.

The fixed prior centroids are left out: JAX places them by the same rule,
but they are a constant that the port's ranks each hold whole.
"""

import jax
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.config import VARIATION as JAX_VARIATION, Config as JaxConfig
from opensetgaitrecognition_pcaa_tpu.parallel import create_mesh as jax_create_mesh
from opensetgaitrecognition_pcaa_tpu.parallel import state_shardings as jax_state_shardings
from opensetgaitrecognition_pcaa_tpu.parallel.mesh import shard_state as jax_shard_state
from opensetgaitrecognition_pcaa_tpu.train.orced import build_orced as jax_build_orced
from opensetgaitrecognition_pcaa_tpu.train.pcaa import (
    VARIANTS as JAX_VARIANTS,
    build_pcaa as jax_build_pcaa,
)

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import leaf_entries, pcaa_state_from_jax
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    shard_state,
    state_shardings,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import ORCEDModules
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, PCAAModules, build_pcaa
from tests.torch_ranks import mesh_layout, shard_roundtrip

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

TINY = dict(NMAX=16, NSTEPS=8, POINTNET_OUT_DIM=64, DTC_FILTERS=(8, 8, 8, 8, 8, 16),
            SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2), BATCH_SIZE=8)
PUBLISHED = dict(TRAIN_CLASSES=(0, 1, 2, 3, 4, 5))  # config.py's widths: PointNet 1024, S 18000


@pytest.mark.parametrize("n,mp", [(4, 2), (4, 1)])
def test_create_mesh_groups_are_jax_s_device_grid(n, mp):
    grid = np.array([[d.id for d in row] for row in jax_create_mesh(n, model_parallel=mp).devices])
    assert grid.shape == (n // mp, mp)
    for rank, d, m, data_group, model_group in launch(mesh_layout, n, mp, backend="gloo"):
        assert grid[d, m] == rank
        assert data_group == sorted(grid[:, m].tolist())
        assert model_group == sorted(grid[d, :].tolist())


def _axis(sharding):
    spec = tuple(sharding.spec)
    return spec.index("model") if "model" in spec else None


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _jax_side(state, kind: str, module: str):
    """(params tree, batch_stats tree, first moments tree) of ``module``
    in a JAX state (or a tree of its shardings)."""
    if kind == "orced":
        return state.params[module], state.batch_stats.get(module, {}), state.opt[0].mu[module]
    if module == "mean_learner":
        return state.ml_params, state.batch_stats[module], None
    side, opt = (("params_g", "opt_g") if module in ("encoder", "decoder", "dec_head")
                 else ("params_d", "opt_d"))
    return (getattr(state, side)[module], state.batch_stats.get(module, {}),
            getattr(state, opt)[0].mu[module])


def _jax_state(kind, cfg, variation):
    if kind == "orced":
        return jax.eval_shape(lambda k: jax_build_orced(cfg, k)[1], jax.random.PRNGKey(0))
    spec = JAX_VARIANTS[JAX_VARIATION(variation.value)]
    return jax.eval_shape(lambda k: jax_build_pcaa(cfg, spec, k)[1], jax.random.PRNGKey(0))


def _port_modules(kind, cfg, variation):
    with torch.device("meta"):
        if kind == "orced":
            return ORCEDModules(cfg, torch.Generator())
        return PCAAModules(cfg, VARIANTS[variation], torch.Generator())


@pytest.mark.parametrize("widths", ["tiny", "published"])
@pytest.mark.parametrize("kind,variation", [("pcaa", VARIATION.V4), ("pcaa", VARIATION.V1),
                                            ("orced", None)], ids=["V4", "V1", "ORCED"])
@pytest.mark.parametrize("min_dim", [128, 16])
def test_port_shards_the_leaves_jax_shards(widths, kind, variation, min_dim):
    dims = TINY if widths == "tiny" else PUBLISHED
    cfg = JaxConfig(MODEL_NAME="M", **dims)
    jstate = _jax_state(kind, cfg, variation)
    jspecs = jax_state_shardings(jstate, jax_create_mesh(2, model_parallel=2), min_dim=min_dim)
    state_dict = _port_modules(kind, Config.from_dict(cfg.to_dict()), variation).state_dict()
    specs = state_shardings(state_dict, 2, min_dim=min_dim)
    entries = leaf_entries(state_dict)
    assert set(entries) == set(state_dict) == set(specs)
    n_sharded = 0
    for key, (module, path, layout) in entries.items():
        params, stats, mu = _jax_side(jspecs, kind, module)
        shapes = _jax_side(jstate, kind, module)
        tree, shape_tree = (params, shapes[0]) if path[0] == "params" else (stats, shapes[1])
        jax_axis = _axis(_at(tree, path[1:]))
        jax_shape = _at(shape_tree, path[1:]).shape
        torch_shape = tuple(state_dict[key].shape)
        assert torch_shape == (jax_shape[::-1] if layout != "plain" else jax_shape), key
        want = None if jax_axis is None else (
            len(jax_shape) - 1 - jax_axis if layout != "plain" else jax_axis)
        assert specs[key] == want, (key, specs[key], jax_axis)
        n_sharded += want is not None
        if mu is not None and path[0] == "params":  # Adam's moments follow their parameter
            assert _axis(_at(mu, path[1:])) == jax_axis, key
    assert n_sharded > 0


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_shard_state_of_a_converted_jax_state_is_jax_s_shard(dp, mp):
    cfg = JaxConfig(MODEL_NAME="M", **TINY)
    mods, jstate = jax_build_pcaa(cfg, JAX_VARIANTS[JAX_VARIATION.V4], jax.random.PRNGKey(0))
    mesh = jax_create_mesh(dp * mp, model_parallel=mp)
    sharded = jax_shard_state(jstate, mesh, min_dim=16)
    where = {dev.id: (i, j) for i, row in enumerate(mesh.devices) for j, dev in enumerate(row)}
    tree = jax.device_get({"params_g": jstate.params_g, "params_d": jstate.params_d,
                           "batch_stats": jstate.batch_stats, "centroids": jstate.centroids,
                           "opt_g": {"count": 0, "mu": jstate.opt_g[0].mu,
                                     "nu": jstate.opt_g[0].nu},
                           "opt_d": {"count": 0, "mu": jstate.opt_d[0].mu,
                                     "nu": jstate.opt_d[0].nu}})
    pmods, pstate = build_pcaa(Config.from_dict(cfg.to_dict()), VARIANTS[VARIATION.V4],
                               device="cpu")
    pcaa_state_from_jax(tree, pmods, pstate)
    full = pmods.state_dict()
    specs = state_shardings(full, mp, min_dim=16)
    entries = leaf_entries(full)
    for rank in range(dp * mp):
        local = shard_state(full, specs, Mesh(dp, mp, rank))
        for key, (module, path, layout) in entries.items():
            params, stats, _ = _jax_side(sharded, "pcaa", module)
            leaf = _at(params if path[0] == "params" else stats, path[1:])
            (shard,) = [s.data for s in leaf.addressable_shards
                        if where[s.device.id] == (rank // mp, rank % mp)]
            got = local[key].numpy()
            got = got.T if layout == "dense" else got.transpose(2, 1, 0) if layout == "conv" \
                else got
            np.testing.assert_array_equal(got, np.asarray(shard), err_msg=f"{key} rank {rank}")


def test_gather_state_undoes_shard_state():
    """Two model ranks: ``shard_modules`` places the tiny V4 at
    ``MP_MIN_DIM`` 16 (each sharded leaf, and its moments, half its rows,
    each in storage of its own); ``gather_state`` gives back the whole
    state_dict, bit for bit."""
    cfg = Config(MODEL_NAME="M", DP_DEVICES=1, MP_DEVICES=2, MP_MIN_DIM=16, **TINY)
    got = launch(shard_roundtrip, 2, cfg, VARIATION.V4, backend="gloo")
    assert got["max_diff"] == 0.0
    assert got["own_storage"]  # a shard is a tensor of its own: aligned, the rest freed
    whole = build_pcaa(cfg.replace(MP_DEVICES=1), VARIANTS[VARIATION.V4], device="cpu")[0]
    assert got["sharded"] and all(k.endswith("weight") for k in got["sharded"])
    for key, t in whole.state_dict().items():
        want = (t.shape[0] // 2,) + tuple(t.shape[1:]) if key in got["sharded"] else tuple(t.shape)
        assert got["shapes"][key] == want, key
        if key.startswith("g.") and key[2:] in got["moment_shapes"]:
            assert got["moment_shapes"][key[2:]] == want, key
