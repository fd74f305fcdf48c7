"""Adam with ``optax.adam`` semantics over a parameter dict.

The JAX package trains with ``optax.adam`` (``train/pcaa.py:299-300``), or
with ``train/optim.py::adam_lowmem``, which equals it at f32 moments. The
state is optax's: a step ``count`` and per-leaf f32 moments ``mu`` and
``nu``, keyed here by parameter name. One step, with ``t = count + 1``:

    mu = (1 − b1)·g + b1·mu
    nu = (1 − b2)·g² + b2·nu
    w  = w + (−lr)·((mu / (1 − b1^t)) / (√(nu / (1 − b2^t)) + eps))

Parameters and moments are updated in place. The narrow-moment options of
the JAX package (``BF16_ADAM_NU``, ``FACTORED_ADAM_NU``) are not ported:
``train/pcaa.py::build_pcaa`` raises on them.
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


def adam_init(params: Iterable[Tuple[str, torch.Tensor]]) -> AdamState:
    """Zero moments for each ``(name, parameter)``, on the parameter's device."""
    params = list(params)
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params},
        nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params},
    )


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
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        w.add_((-lr) * ((m / c1) / (torch.sqrt(v / c2) + eps)))
