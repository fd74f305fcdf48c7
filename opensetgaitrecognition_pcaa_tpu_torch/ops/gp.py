"""WGAN gradient penalty by double differentiation.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/gp.py:21-49``: interpolate
between prior samples ``z`` and encoder codes, take the critic's gradient
with respect to the interpolates (``torch.autograd.grad`` with
``create_graph=True``, so that the outer loss differentiates through it),
and penalize ``(‖g‖₂ − 1)²``. Two-sided, as the reference: not the
one-sided ``relu(‖g‖ − 1)²`` variant.
"""

from __future__ import annotations

from typing import Callable

import torch


def gradient_penalty(
    critic: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    codes: torch.Tensor,
    alphas: torch.Tensor,
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
    (grads,) = torch.autograd.grad(
        torch.sum(critic(interpolates)), interpolates, create_graph=True
    )
    slopes = torch.sqrt(torch.sum(grads**2, dim=1) + 1e-12)
    return torch.mean((slopes - 1.0) ** 2)
