"""Rank functions of the port's data- and tensor-parallel tests.

``parallel/mesh.py::launch`` runs each in processes of its own, which
unpickle it by this module's name: so this module imports torch and the
port only, never JAX or a test module (``tests/conftest.py`` imports JAX).
Each builds what its rank holds from numpy inputs that every rank is given
whole, and returns host values; rank 0's return value reaches the test.
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import orced_state_from_jax, pcaa_state_from_jax
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import pointnet_pool_train
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    gather_state,
    reduce_grads,
    shard_state,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import build_orced, make_orced_epoch_fns
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    full_resume_tree,
    make_epoch_fns,
    place_state,
    run_mesh,
    weight_cache,
)


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def pcaa_steps(cfg: Config, variation: VARIATION, tree: Optional[Dict], data: Dict) -> Dict:
    """``cfg``'s PCAA run (on ``DP_DEVICES × MP_DEVICES`` ranks where that
    is above one) from the JAX state ``tree`` (or ``cfg.SEED``'s init):
    the steps of ``data`` (``x``, ``y``, ``perm`` (steps, B), ``z0``,
    ``alphas`` (steps, B, ...)) with the noise injected → the per-step
    global metrics and the whole state after them (``full_resume_tree``)."""
    torch.set_num_threads(1)
    mods, state = build_pcaa(cfg, VARIANTS[variation], device="cpu")
    if tree is not None:
        pcaa_state_from_jax(tree, mods, state)
    mesh = run_mesh(cfg)
    opts = {"opt_g": (state.opt_g, "g."), "opt_d": (state.opt_d, "d.")}
    specs = place_state(mods, opts, mesh, cfg.MP_MIN_DIM)
    if cfg.BF16_WEIGHT_CACHE:  # the copies of the placed masters, as train_pcaa makes them
        state.cast_g = weight_cache(mods.g)
    train_epoch, _ = make_epoch_fns(mods, cfg, mesh)
    state, m = train_epoch(state, torch.from_numpy(data["x"]), torch.from_numpy(data["y"]),
                           data["perm"], noise=(data["z0"], data["alphas"]))
    return {"metrics": _host(m), "state": full_resume_tree(mods, opts, state.generator, mesh,
                                                            specs, centroids=state.centroids)}


def orced_steps(cfg: Config, tree: Optional[Dict], data: Dict, kl_mult: float) -> Dict:
    """``pcaa_steps`` for an OR-CED run: ``data`` holds ``eps`` (steps, B,
    latent) for the reparametrization."""
    torch.set_num_threads(1)
    mods, state = build_orced(cfg, device="cpu")
    if tree is not None:
        orced_state_from_jax(tree, mods, state)
    mesh = run_mesh(cfg)
    opts = {"opt": (state.opt, "")}
    specs = place_state(mods, opts, mesh, cfg.MP_MIN_DIM)
    train_epoch, _ = make_orced_epoch_fns(mods, cfg, mesh)
    state, m = train_epoch(state, torch.from_numpy(data["x"]), torch.from_numpy(data["y"]),
                           data["perm"], kl_mult, noise=data["eps"])
    return {"metrics": _host(m), "state": full_resume_tree(mods, opts, state.generator, mesh,
                                                            specs)}


def pointnet_grads(x: np.ndarray, params, cotangent: np.ndarray, model_parallel: int,
                   min_dim: int, store_dtype: torch.dtype = torch.float32) -> Dict:
    """The plain train-mode PointNet (``pointnet_pool_train`` on the CPU)
    on a mesh of the world's ranks: this data rank's rows of ``x``, W
    column-sharded where the JAX rule shards ``(in, out)`` at ``min_dim``;
    the objective ``Σ pooled · cotangent`` of its rows, 1/MP of it on each
    rank of a model group; the gradients summed as the trainers sum them
    (``reduce_grads``) → the global batch's pooled output, means and
    variances, and every leaf's whole gradient."""
    torch.set_num_threads(1)
    mesh = create_mesh(model_parallel=model_parallel)
    rows = batch_sharding(mesh, x.shape[0])
    full = {f"{i}.{j}": torch.from_numpy(p) for i, layer in enumerate(params)
            for j, p in enumerate(layer)}
    # W (in, out) is sharded on its columns (axis 1) where out divides and reaches min_dim
    specs = {k: 1 if k.endswith(".0") and t.shape[1] % mesh.mp == 0 and t.shape[1] >= min_dim
             else None for k, t in full.items()}
    local = {k: t.clone().requires_grad_(True) for k, t in shard_state(full, specs, mesh).items()}
    layers = [tuple(local[f"{i}.{j}"] for j in range(4)) for i in range(len(params))]
    pooled, means, variances = pointnet_pool_train(torch.from_numpy(x[rows]), layers,
                                                   store_dtype, mesh)
    loss = torch.sum(pooled * torch.from_numpy(cotangent[rows])) / mesh.mp
    grads = dict(zip(local, torch.autograd.grad(loss, list(local.values()))))
    reduce_grads(grads, specs, mesh)
    grads = gather_state(grads, specs, mesh)
    pooled = mesh.gather_data(pooled.detach(), 0)
    dist.barrier()
    return {"pooled": pooled.numpy(), "means": [m.numpy() for m in means],
            "vars": [v.numpy() for v in variances],
            "grads": {k: g.numpy() for k, g in grads.items()}}


def mesh_layout(model_parallel: int) -> list:
    """Every rank's ``(rank, data index, model index, its data group's
    ranks, its model group's ranks)`` on ``create_mesh(model_parallel=)``."""
    mesh = create_mesh(model_parallel=model_parallel)

    def ranks(group):
        return [mesh.rank] if group is None else dist.get_process_group_ranks(group)

    mine = (mesh.rank, mesh.data_rank, mesh.model_rank, ranks(mesh.data_group),
            ranks(mesh.model_group))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def shard_roundtrip(cfg: Config, variation: VARIATION) -> Dict:
    """``cfg.SEED``'s PCAA modules, sharded by ``shard_modules`` (as the
    trainers place them) and gathered back by ``gather_state`` → the
    largest difference to the whole state_dict, the sharded keys and this
    rank's shard shapes."""
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import shard_modules

    mods, state = build_pcaa(cfg, VARIANTS[variation], device="cpu")
    whole = {k: v.clone() for k, v in mods.state_dict().items()}
    mesh = create_mesh(model_parallel=cfg.MP_DEVICES)
    moments = [(m, p) for opt, p in ((state.opt_g, "g."), (state.opt_d, "d."))
               for m in (opt.mu, opt.nu)]
    specs = shard_modules(mods, moments, mesh, min_dim=cfg.MP_MIN_DIM)
    local = mods.state_dict()
    back = gather_state(local, specs, mesh)
    own = all(t.storage_offset() == 0 and t.untyped_storage().nbytes() == t.numel() * 4
              for k, t in local.items() if specs[k] is not None)
    return {"max_diff": max(float((back[k] - whole[k]).abs().max()) for k in whole),
            "own_storage": own,
            "sharded": sorted(k for k, a in specs.items() if a is not None),
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "moment_shapes": {k: tuple(v.shape) for k, v in state.opt_g.mu.items()}}
