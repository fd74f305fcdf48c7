"""WGAN gradient penalty by double differentiation.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/gp.py:21-49``: interpolate
between prior samples ``z`` and encoder codes, take the critic's gradient
with respect to the interpolates (``torch.autograd.grad`` with
``create_graph=True``, so that the outer loss differentiates through it),
and penalize ``(‖g‖₂ − 1)²``. Two-sided, as the reference: not the
one-sided ``relu(‖g‖ − 1)²`` variant.

With a ``mesh`` (``parallel/mesh.py``) the batch's rows lie on the data
group and the critic may hold column shards: every rank of a model group
computes the critic alike, so each takes 1/MP of its summed output, and the
parts of the input gradient are summed over the model group (a
differentiable all-reduce) before the norm; the mean is over this data
rank's rows (``train/pcaa.py::mesh_grads`` takes the rank's share).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import Mesh


def gradient_penalty(
    critic: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    codes: torch.Tensor,
    alphas: torch.Tensor,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """``mean((‖∂critic/∂x‖₂ − 1)²)`` at ``x = z + alphas·(codes − z)``.

    :param critic: ``(B, D)`` latents → ``(B,)`` or ``(B, 1)`` logits; the
        label conditioning is closed over by the caller.
    :param alphas: ``(B, 1)`` uniforms, broadcast over the latent dim as
        the reference draws them.
    """
    interpolates = z + alphas * (codes - z)
    if not interpolates.requires_grad:
        interpolates = interpolates.detach().requires_grad_(True)
    # the critic is per sample, so the gradient of the summed output is
    # the stack of per-sample input gradients
    out = torch.sum(critic(interpolates))
    if mesh is not None and mesh.mp > 1:
        out = out / mesh.mp
    (grads,) = torch.autograd.grad(out, interpolates, create_graph=True)
    if mesh is not None:
        grads = mesh.sum_model(grads)
    slopes = torch.sqrt(torch.sum(grads**2, dim=1) + 1e-12)
    return torch.mean((slopes - 1.0) ** 2)
