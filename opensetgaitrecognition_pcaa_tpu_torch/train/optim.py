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
under ``jit`` the product is not rounded again. ``FACTORED_ADAM_NU`` is
not ported: ``train/pcaa.py::build_pcaa`` raises on it.
``adam_state_tree`` and ``load_adam_state_tree`` carry a state to and from
the tree of the resume file (``train/run_folder.py::save_train_state``,
which writes bf16 leaves as flax does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    # optax.adam's b1·mu in mu's dtype (the module docstring); no effect on f32 mu
    optax_mu: bool = False


def adam_init(params: Iterable[Tuple[str, torch.Tensor]], *,
              mu_dtype: torch.dtype = torch.float32, nu_dtype: torch.dtype = torch.float32,
              optax_mu: bool = False) -> AdamState:
    """Zero moments for each ``(name, parameter)``, on the parameter's
    device, stored in ``mu_dtype`` and ``nu_dtype``."""
    params = list(params)
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(p, dtype=mu_dtype) for k, p in params},
        nu={k: torch.zeros_like(p, dtype=nu_dtype) for k, p in params},
        optax_mu=optax_mu,
    )


def _b1_for(state: AdamState, m: torch.Tensor, b1: float) -> float:
    """The b1 that multiplies ``m``: b1 rounded to m's dtype where
    ``optax_mu`` applies."""
    if state.optax_mu and m.dtype != torch.float32:
        return float(torch.tensor(b1, dtype=m.dtype))
    return b1


@torch.no_grad()
def adam_update_(state: AdamState, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], *, lr: float, b1: float, b2: float,
                 eps: float = 1e-8) -> None:
    """One ``optax.adam`` step, in place on ``params`` and ``state``."""
    state.count += 1
    t = np.float32(state.count)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    for name, w in params.items():
        g, m, v = grads[name], state.mu[name], state.nu[name]
        m2 = (1.0 - b1) * g + _b1_for(state, m, b1) * m.float()
        v2 = (1.0 - b2) * (g * g) + b2 * v.float()
        w.add_((-lr) * ((m2 / c1) / (torch.sqrt(v2 / c2) + eps)))
        m.copy_(m2)
        v.copy_(v2)


def host_leaf(t: torch.Tensor):
    """``t`` on the host for a resume tree: a numpy array, or for bf16 (which
    numpy lacks) a CPU tensor, which the run-folder codec writes as flax
    writes a bf16 array."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def adam_state_tree(state: AdamState) -> Dict:
    """``{"count", "mu", "nu"}`` with host leaves (``host_leaf``)."""
    return {
        "count": np.asarray(state.count, np.int64),
        "mu": {k: host_leaf(v) for k, v in state.mu.items()},
        "nu": {k: host_leaf(v) for k, v in state.nu.items()},
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
