"""Adam with ``optax.adam`` semantics over a parameter dict.

The JAX package trains with ``optax.adam`` (``train/pcaa.py:299-300``), or
with ``train/optim.py::adam_lowmem``, which equals it at f32 moments. The
state is optax's: a step ``count`` and per-leaf moments ``mu`` and ``nu``,
keyed here by parameter name. One step, with ``t = count + 1``:

    mu = (1 − b1)·g + b1·mu
    nu = (1 − b2)·g² + b2·nu
    w  = w + (−lr)·((mu / (1 − b1^t)) / (√(nu / (1 − b2^t)) + eps))

Parameters and moments are updated in place. Each moment tree is stored
f32 or bf16 (JAX ``mu_dtype``: bf16 under bf16 compute; ``nu_dtype``: bf16
with ``BF16_ADAM_NU``). The arithmetic is f32: a bf16 moment is upcast,
the update is formed from the f32 moments before they are rounded, and
they are rounded to bf16 (nearest even) only when stored
(``adam_lowmem``, ``train/optim.py:60-100`` of the JAX package). One
quirk of ``optax.adam(mu_dtype=bf16)``, which the JAX package uses under
bf16 compute without ``BF16_ADAM_NU`` or ``FUSED_ADAM``, is kept
(``AdamState.optax_mu``): its ``b1·mu`` is taken in mu's dtype, jnp's
weak typing rounding the constant b1 to bf16 (0.9 becomes 0.8984375), and
under ``jit`` the product is not rounded again.

``adam_init(factored_min_elems=)`` makes the state of JAX
``train/optim.py::adam_factored`` (``Config.FACTORED_ADAM_NU``): a 2-D leaf
of at least that many elements keeps, in place of ``nu``, an
Adafactor-style rank-1 second moment ``{"r", "c"}`` in f32; every other
leaf keeps an exact f32 ``nu``, and ``mu`` stays Adam's. The port's 2-D
leaves are dense kernels ``(out, in)``, the transposes of the JAX kernels
``(in, out)`` (``convert.py``), so JAX's row factor ``r`` (one value per
JAX row, ``in`` of them) is the sum over the port's axis 0 and its column
factor ``c`` (``out``) the sum over axis 1. One step of such a leaf, with
``sq = g² + 1e-30``:

    r = b2·r + (1 − b2)·Σ_out sq       c = b2·c + (1 − b2)·Σ_in sq
    v̂ = (r / (c2·Σr)) ⊗ c              w = w + (−lr)·((mu / c1) / (√v̂ + eps))

``adam_update_(row_sum=)`` completes the partial sums ``Σ_out sq`` of a leaf
that tensor parallelism shards over its output axis (``parallel/mesh.py``).

``adam_update_(skip_write=)`` updates the moments of the named leaves and
leaves their parameters alone; ``adam_write_`` applies that pending
parameter write later from the stored moments (JAX
``train/pcaa.py::_deferred_decoder_write``, ``Config.DEFERRED_DECODER_UPDATE``),
with the expression of ``adam_update_``, so that at f32 moments the
deferred schedule gives the plain one's bits.

``adam_state_tree`` and ``load_adam_state_tree`` carry a state to and from
the tree of the resume file (``train/run_folder.py::save_train_state``,
which writes bf16 leaves as flax does), a factored leaf as its
``{"r", "c"}``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Collection, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch


# JAX train/optim.py::_FACTORED_MIN_ELEMS: 2-D leaves at least this big are factored
FACTORED_MIN_ELEMS = 1 << 20
# Adafactor's epsilon_1, added to g² before the row and column sums
_EPS2 = 1e-30

# a leaf's second moment: a tensor, or a factored leaf's {"r", "c"}
Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, Moment]
    # optax.adam's b1·mu in mu's dtype (the module docstring); no effect on f32 mu
    optax_mu: bool = False


def adam_init(params: Iterable[Tuple[str, torch.Tensor]], *,
              mu_dtype: torch.dtype = torch.float32, nu_dtype: torch.dtype = torch.float32,
              optax_mu: bool = False,
              factored_min_elems: Optional[int] = None) -> AdamState:
    """Zero moments for each ``(name, parameter)``, on the parameter's
    device, stored in ``mu_dtype`` and ``nu_dtype``; with
    ``factored_min_elems``, a 2-D leaf of at least that many elements gets
    the factored ``{"r": (in,), "c": (out,)}`` in f32 instead of ``nu``."""
    params = list(params)

    def nu(p):
        if factored_min_elems is not None and p.dim() == 2 and p.numel() >= factored_min_elems:
            return {"r": p.new_zeros(p.shape[1]), "c": p.new_zeros(p.shape[0])}
        return torch.zeros_like(p, dtype=nu_dtype)

    return AdamState(
        count=0,
        mu={k: torch.zeros_like(p, dtype=mu_dtype) for k, p in params},
        nu={k: nu(p) for k, p in params},
        optax_mu=optax_mu,
    )


def map_moment(fn: Callable[[torch.Tensor, str], torch.Tensor], v: Moment) -> Moment:
    """``fn(tensor, part)`` over a second moment: ``part`` is "nu" for a
    tensor, "r" or "c" for a factored leaf's factors."""
    if isinstance(v, dict):
        return {k: fn(t, k) for k, t in v.items()}
    return fn(v, "nu")


def _b1_for(state: AdamState, m: torch.Tensor, b1: float) -> float:
    """The b1 that multiplies ``m``: b1 rounded to m's dtype where
    ``optax_mu`` applies."""
    if state.optax_mu and m.dtype != torch.float32:
        return float(torch.tensor(b1, dtype=m.dtype))
    return b1


def _bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 − b1^t, 1 − b2^t)`` at ``t = count``, in f32 as the JAX
    package computes them."""
    t = np.float32(count)
    return (float(np.float32(1.0) - np.float32(b1) ** t),
            float(np.float32(1.0) - np.float32(b2) ** t))


def _step(m2: torch.Tensor, vhat: torch.Tensor, c1: float, eps: float) -> torch.Tensor:
    """Adam's update direction from the new first moment and the
    bias-corrected second moment."""
    return (m2 / c1) / (torch.sqrt(vhat) + eps)


@torch.no_grad()
def adam_update_(state: AdamState, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], *, lr: float, b1: float, b2: float,
                 eps: float = 1e-8, skip_write: Collection[str] = (),
                 row_sum: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> None:
    """One ``optax.adam`` step, in place on ``params`` and ``state``
    (``adam_factored``'s on a factored leaf). The leaves named in
    ``skip_write`` update their moments only (``adam_write_`` applies their
    write later). ``row_sum(name, partial)`` completes a factored leaf's
    sums over its output axis where tensor parallelism shards it (the
    module docstring); by default they are whole."""
    state.count += 1
    c1, c2 = _bias_corrections(state.count, b1, b2)
    for name, w in params.items():
        g, m, v = grads[name], state.mu[name], state.nu[name]
        m2 = (1.0 - b1) * g + _b1_for(state, m, b1) * m.float()
        if isinstance(v, dict):  # factored (JAX scale_by_adam_factored)
            sq = g * g + _EPS2
            rows = torch.sum(sq, dim=0)
            if row_sum is not None:
                rows = row_sum(name, rows)
            r = b2 * v["r"] + (1.0 - b2) * rows
            c = b2 * v["c"] + (1.0 - b2) * torch.sum(sq, dim=1)
            vhat = (r[None, :] / (c2 * torch.sum(r))) * c[:, None]
            v["r"].copy_(r)
            v["c"].copy_(c)
        else:
            v2 = (1.0 - b2) * (g * g) + b2 * v.float()
            vhat = v2 / c2
            v.copy_(v2)
        if name not in skip_write:
            w.add_((-lr) * _step(m2, vhat, c1, eps))
        m.copy_(m2)


@torch.no_grad()
def adam_write_(state: AdamState, params: Dict[str, torch.Tensor], *, lr: float, b1: float,
                b2: float, eps: float = 1e-8) -> None:
    """The parameter write of the last ``adam_update_`` step, from the
    stored moments, for each leaf of ``params`` (those it skipped, JAX
    ``_deferred_decoder_write``); nothing before the first step, where no
    write is pending (JAX's guard against a count of 0). At f32 moments the
    stored moments are the ones that step computed, so the parameters get
    that step's bits."""
    if state.count == 0:
        return
    c1, c2 = _bias_corrections(state.count, b1, b2)
    for name, w in params.items():
        vhat = state.nu[name].float() / c2
        w.add_((-lr) * _step(state.mu[name].float(), vhat, c1, eps))


def host_leaf(t: torch.Tensor):
    """``t`` on the host for a resume tree: a numpy array, or for bf16 (which
    numpy lacks) a CPU tensor, which the run-folder codec writes as flax
    writes a bf16 array."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def adam_state_tree(state: AdamState) -> Dict:
    """``{"count", "mu", "nu"}`` with host leaves (``host_leaf``), a
    factored leaf's ``nu`` as its ``{"r", "c"}``."""
    return {
        "count": np.asarray(state.count, np.int64),
        "mu": {k: host_leaf(v) for k, v in state.mu.items()},
        "nu": {k: map_moment(lambda t, _: host_leaf(t), v) for k, v in state.nu.items()},
    }


@torch.no_grad()
def load_tensors_(dst: Dict[str, torch.Tensor], src: Dict, what: str) -> None:
    """Copy the arrays (or bf16 tensors) ``src`` into the tensors ``dst`` in
    place, on their devices; ``ValueError`` where their names, shapes or
    dtypes differ."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: the saved entries differ from the run's "
                         f"({sorted(set(dst) ^ set(src))[:4]} ...)")
    for k, t in dst.items():
        a = src[k]
        if isinstance(t, dict):  # a factored second moment
            if not isinstance(a, dict):
                raise ValueError(f"{what}[{k!r}]: saved a full moment, the run factors it")
            load_tensors_(t, a, f"{what}[{k!r}]")
            continue
        if isinstance(a, dict):
            raise ValueError(f"{what}[{k!r}]: saved a factored moment, the run keeps it whole")
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what}[{k!r}]: saved shape {tuple(a.shape)}, "
                             f"run {tuple(t.shape)}")
        if a.dtype != t.dtype:
            raise ValueError(f"{what}[{k!r}]: saved {a.dtype}, run {t.dtype}")
        t.copy_(a)


def load_adam_state_tree(state: AdamState, tree: Dict) -> None:
    """Load an ``adam_state_tree`` into ``state`` in place, on its devices."""
    load_tensors_(state.mu, tree["mu"], "mu")
    load_tensors_(state.nu, tree["nu"], "nu")
    state.count = int(np.asarray(tree["count"]))
