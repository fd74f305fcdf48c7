"""Data and tensor parallelism over a ``(data, model)`` grid of ranks.

Port of ``opensetgaitrecognition_pcaa_tpu/parallel/mesh.py``. The JAX
package annotates shardings and lets GSPMD place the collectives, so a
sharded step is the single-device step's math exactly. Here each rank is a
process of ``torch.distributed`` and the collectives are placed by hand,
keeping four properties, so that a run over ``DP × MP`` ranks equals the
single-device run up to the order of its sums:

- **objectives**: the objectives of all ranks sum to the single-device
  loss. A rank's loss is its estimate of the global one (means over its
  rows, the values of the global batch where a loss needs it whole, as
  the triplet grid), and its objective is 1/(DP × MP) of it
  (``train/pcaa.py::mesh_grads``): a data rank's share of every global
  mean is its local sum over the global batch, and the ranks of a model
  group, which compute the same loss from the same gathered tensors, each
  take 1/MP of it;
- **adjoints**: every collective differentiates through its true adjoint:
  an all-reduce-sum has an all-reduce-sum backward, an all-gather a
  reduce-scatter-sum backward (and back), so second derivatives (the
  gradient penalty) cross ranks too;
- **replicated leaves** have their gradients summed over every rank, and
- **sharded leaves** over the data group only (``reduce_grads``).

Adam then steps each rank's local leaf as the single-device Adam would.
A factored second moment (``FACTORED_ADAM_NU``, ``train/optim.py``) of a
sharded leaf is split as GSPMD splits it for JAX: its column factor ``c``
(one value per output row) with the leaf, its row factor ``r`` replicated,
made whole each step from the ranks' partial sums over the output axis
(``train/pcaa.py::model_row_sum``), so that ``Σr`` is the whole leaf's.
A ``BF16_WEIGHT_CACHE`` copy is made from the rank's shard, and Adam's
write (deferred or not) is elementwise on the shards.

Tensor parallelism shards the leaves that JAX ``state_shardings`` shards:
a leaf of at least two axes whose JAX output axis (the last) divides by the
model size and is at least ``min_dim`` wide. Every such leaf of the port is
a dense kernel, ``Linear.weight`` ``(out, in)`` of JAX ``(in, out)``, or a
conv kernel, ``Conv1d.weight`` ``(out, in, k)`` of JAX ``(k, in, out)``
(``convert.py``), so the JAX output axis is the torch axis 0, and a model
rank holds rows ``[m·out/MP, (m+1)·out/MP)`` of it as a contiguous tensor of
its own. Its module computes its columns of the output and all-gathers
them (``models/layers.py``; the train-mode PointNet kernel in
``ops/pointnet_train.py``); BatchNorm takes its statistics over the data
group (``models/norm.py``).

Ranks are processes: ``launch`` spawns them on one host. The backend is the
caller's choice, never guessed: ``nccl`` where each rank has a card of its
own, ``gloo`` where ranks share one card (gloo moves CUDA tensors through
the host) or run on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of ``dp × mp`` ranks, row-major as JAX
    ``create_mesh`` lays out devices: rank ``r`` is at data index
    ``r // mp`` and model index ``r % mp``. ``data_group`` holds the ranks
    of this rank's model index (the same shard, other rows of the batch),
    ``model_group`` those of its data index (the same rows, other shards);
    either is None where it would hold this rank alone."""

    dp: int
    mp: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp

    @property
    def world_group(self):
        return None if self.dp * self.mp == 1 else dist.group.WORLD

    # the differentiable collectives of the two axes; each is the identity
    # on an axis of one rank
    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.data_group)

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.model_group)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return all_gather(x, dim, self.data_group)

    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return all_gather(x, dim, self.model_group)


def create_mesh(n_devices: Optional[int] = None, *, model_parallel: int = 1) -> Mesh:
    """This rank's place on a ``(n // model_parallel, model_parallel)``
    grid of the ranks of the default process group, with its data and
    model groups (every rank makes every group, in one order, as
    ``torch.distributed.new_group`` requires).

    The default group must be initialised with a world size of ``n``
    (``launch`` starts such ranks)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs one process per rank with torch.distributed initialised: start the "
            "ranks with parallel.mesh.launch(fn, n, ..., backend='gloo' or 'nccl'), or call "
            "torch.distributed.init_process_group(backend, init_method='tcp://localhost:<port>', "
            "world_size=n, rank=r) in each")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise RuntimeError(f"a mesh of {n} ranks needs a world of {n}; this one has {world}")
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of {model_parallel}")
    dp, mp = n // model_parallel, model_parallel
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(mp):  # a data group per model index
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m and dp > 1:
            data_group = g
    for d in range(dp):  # a model group per data index
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d and mp > 1:
            model_group = g
    return Mesh(dp, mp, rank, data_group, model_group)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows: its data
    index's contiguous block, as JAX ``P("data")`` places them."""
    if batch % mesh.dp:
        raise ValueError(f"a batch of {batch} does not split over {mesh.dp} data ranks")
    n = batch // mesh.dp
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def replicated(mesh: Mesh) -> None:
    """The spec of a leaf that every rank holds whole (JAX ``P()``)."""
    return None


# --- the collectives, each differentiating through its adjoint -----------------


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the group, of which each rank keeps its block along
    ``dim`` (an all-reduce and a slice: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        n = y.shape[dim] // _size(group)
        return y.narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.dim, ctx.group), None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; ``x`` where the group
    is None (one rank)."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    return x if group is None else _AllGather.apply(x, dim % x.dim(), group)


# --- the tensor-parallel rule and the state's placement ------------------------


def _leaf_spec(shape: Tuple[int, ...], model_size: int, min_dim: int) -> Optional[int]:
    """JAX ``_leaf_spec`` on a JAX shape → the sharded JAX axis (the last),
    or None for a replicated leaf."""
    if len(shape) >= 2 and shape[-1] % model_size == 0 and shape[-1] >= min_dim:
        return len(shape) - 1
    return None


def state_shardings(tensors: Dict[str, Any], model_size: int, *,
                    min_dim: int = 128) -> Dict[str, Optional[int]]:
    """Per leaf of a ``PCAAModules`` or ``ORCEDModules`` state_dict (its
    tensors or their shapes, at full width): the torch axis that the model
    group shards, or None where every rank holds the leaf whole, by JAX
    ``state_shardings``' rule on the leaf's JAX shape (``convert.py``'s
    tables: a dense or conv kernel reverses the torch axes, so a sharded
    leaf is sharded on its torch axis 0). Adam's moments have their
    parameter's shape and follow it (``sub_specs``)."""
    from opensetgaitrecognition_pcaa_tpu_torch.convert import leaf_entries

    entries = leaf_entries(tensors)
    specs = {}
    for name, t in tensors.items():
        if name not in entries:
            raise ValueError(f"{name!r} is no leaf of convert.py's tables")
        shape = tuple(getattr(t, "shape", t))
        reverse = entries[name][2] != "plain"
        axis = _leaf_spec(shape[::-1] if reverse else shape, model_size, min_dim)
        specs[name] = None if axis is None else (len(shape) - 1 - axis if reverse else axis)
    return specs


def _factored_axis(axis: Optional[int]) -> Optional[int]:
    """The axis of a factored moment's ``c`` where its leaf is sharded on
    ``axis``: the leaf's output axis 0 is ``c``'s only one."""
    return None if axis is None else 0


def shard_tensor(t: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This model rank's block of ``t`` along ``axis`` as a contiguous
    tensor of its own (a copy: a view would keep the whole leaf alive and
    start where the kernels' aligned loads may not); ``t`` where ``axis``
    is None."""
    if axis is None:
        return t
    n = t.shape[axis] // mesh.mp
    return t.narrow(axis, mesh.model_rank * n, n).clone(memory_format=torch.contiguous_format)


def shard_state(tensors: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Full tensors → this rank's (sharded leaves sliced, the rest as
    given)."""
    return {k: shard_tensor(t, specs.get(k), mesh) for k, t in tensors.items()}


@torch.no_grad()
def gather_state(tensors: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state``: each sharded leaf all-gathered over
    the model group, in one order on every rank (every rank calls it); a
    factored second moment's ``c`` gathered whole, its ``r`` as it is."""

    def gather(t, axis):
        if axis is None or mesh.model_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.mp)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim=axis)

    out = {}
    for k, t in tensors.items():
        axis = specs.get(k)
        if isinstance(t, dict):
            out[k] = {"r": t["r"], "c": gather(t["c"], _factored_axis(axis))}
        else:
            out[k] = gather(t, axis)
    return out


def sub_specs(specs: Dict[str, Optional[int]], prefix: str) -> Dict[str, Optional[int]]:
    """The specs of the keys under ``prefix``, the prefix taken off (a
    module side's parameters, as its Adam state names them)."""
    return {k[len(prefix):]: v for k, v in specs.items() if k.startswith(prefix)}


def _kernel_keys(mods: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """state_dict key of each dense or conv kernel → its layer."""
    from opensetgaitrecognition_pcaa_tpu_torch.models.layers import CausalDilatedConv1d, TorchDense

    out = {}
    for name, m in mods.named_modules():
        key = name + "." if name else ""
        if isinstance(m, TorchDense):
            out[key + "weight"] = m
        elif isinstance(m, CausalDilatedConv1d):
            out[key + "conv.weight"] = m
    return out


def module_specs(mods: torch.nn.Module) -> Dict[str, Optional[int]]:
    """The specs of ``mods.state_dict()``'s keys as its layers hold them:
    axis 0 for the kernel of a dense or conv layer that holds a mesh, None
    for every other leaf."""
    sharded = {k for k, m in _kernel_keys(mods).items() if m.mesh is not None}
    return {k: 0 if k in sharded else None for k in mods.state_dict()}


def global_shapes(tensors: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                  mesh: Mesh) -> Dict[str, Tuple[int, ...]]:
    """The full shape of each (possibly sharded) leaf of ``tensors``."""
    out = {}
    for k, t in tensors.items():
        shape = list(t.shape)
        if specs.get(k) is not None:
            shape[specs[k]] *= mesh.mp
        out[k] = tuple(shape)
    return out


@torch.no_grad()
def shard_modules(mods: torch.nn.Module, moments: Iterable[Tuple[Dict[str, torch.Tensor], str]],
                  mesh: Mesh, *, min_dim: int = 128) -> Dict[str, Optional[int]]:
    """Place full-width modules and their Adam moments on ``mesh``, in
    place: each sharded parameter, and its moments in each ``(moment dict,
    key prefix of its parameters in mods)``, become this rank's block; the
    dense and conv layers holding a sharded kernel and every BatchNorm take
    ``mesh`` (``models/layers.py``, ``models/norm.py``). → the specs of
    ``mods.state_dict()``'s keys (``module_specs``), for ``gather_state``
    and ``reduce_grads``."""
    from opensetgaitrecognition_pcaa_tpu_torch.models.norm import TorchBatchNorm

    specs = state_shardings(mods.state_dict(), mesh.mp, min_dim=min_dim)
    kernels = _kernel_keys(mods)
    stray = [k for k, axis in specs.items() if axis is not None and k not in kernels]
    if stray:
        raise ValueError(f"no layer of the port computes these leaves sharded: {stray}")
    for name, p in mods.named_parameters():
        p.data = shard_tensor(p.data, specs[name], mesh)
    for tensors, prefix in moments:
        for k in list(tensors):
            t, axis = tensors[k], specs[prefix + k]
            if isinstance(t, dict):  # a factored second moment (the module docstring)
                tensors[k] = {"r": t["r"], "c": shard_tensor(t["c"], _factored_axis(axis), mesh)}
            else:
                tensors[k] = shard_tensor(t, axis, mesh)
    for key, layer in kernels.items():
        if specs[key] is not None:
            layer.mesh = mesh
    for m in mods.modules():
        if isinstance(m, TorchBatchNorm):
            m.mesh = mesh
    return specs


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                 mesh: Mesh) -> None:
    """Sum each gradient, in place, over the ranks that hold its leaf:
    every rank for a replicated leaf, the data group for a sharded one;
    one all-reduce of a flat buffer per kind."""
    for group, names in ((mesh.world_group, [k for k in grads if specs.get(k) is None]),
                         (mesh.data_group, [k for k in grads if specs.get(k) is not None])):
        if group is None or not names:
            continue
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=group)
        offset = 0
        for k in names:
            n = grads[k].numel()
            grads[k].copy_(flat[offset:offset + n].view_as(grads[k]))
            offset += n


# --- starting ranks ------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, n: int, backend: str, store: str, results, args: tuple,
               kw: dict) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank)
    try:
        out = fn(*args, **kw)
        if rank == 0:  # pickled by value: no tensor shared with a process that ends
            results.put(("ok", pickle.dumps(out)))
    except BaseException:
        results.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, backend: str, timeout: float = 3600.0, **kw) -> Any:
    """Run ``fn(*args, **kw)`` on ``n`` ranks, each a process started by
    ``torch.multiprocessing`` (spawn) with the default process group
    initialised (``backend``, a file store in a temporary directory of its
    own, so that launches side by side never meet; ranks 0..n-1) →
    rank 0's return value. ``backend``: "nccl" with a card per rank
    (rank r on ``cuda:r``), "gloo" for ranks that share one card or run on
    the CPU. ``fn``, its arguments and its result are pickled: ``fn`` is a
    module-level function. A rank that raises makes ``launch`` raise, after
    every rank has stopped."""
    import torch.multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="mesh_store_")
    procs = mp.start_processes(
        _rank_main, args=(fn, n, backend, os.path.join(store_dir, "store"), results, args, kw),
        nprocs=n, join=False, start_method="spawn")
    got: List[tuple] = []
    waited = 0.0
    try:
        while True:
            try:
                got.append(results.get(timeout=0.5))
            except queue.Empty:
                pass
            errors = [msg for status, msg in got if status == "error"]
            if errors:
                raise RuntimeError("a rank failed:\n" + "\n".join(errors))
            if procs.join(timeout=0.5):
                break
            waited += 1.0
            if waited > timeout:
                raise TimeoutError(f"the {n} ranks did not finish in {timeout} s")
        while not any(status == "ok" for status, _ in got):
            got.append(results.get(timeout=60))
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        shutil.rmtree(store_dir, ignore_errors=True)
    return pickle.loads(next(out for status, out in got if status == "ok"))
