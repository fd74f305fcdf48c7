"""Eval-mode ``CGEncoder`` and ``ORCEDEncoder`` forwards with every
BatchNorm folded.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/fast_encoder.py:31-167``:

    PointNet + pool    (the CUDA kernel, ops/pointnet_infer.py)
    → 6 × (causal dilated conv with BN folded into kernel and bias, ELU)
    → mean over time
    → CGEncoder: dense + ELU (+ projection head) → dense + ELU logits;
      ORCEDEncoder: dense mu and logvar, z = mu + eps·exp(logvar / 2),
      dense logits, no ELU

The TCN stays ``F.conv1d`` and the heads stay ``torch.matmul``, as the JAX
package leaves both to XLA. ``use_kernel=False`` takes the plain PointNet
version on the card too, for comparison.

``encoder_eval`` and ``orced_encoder_eval`` are the forwards without an
autograd mode of their own, with the PointNet stage a parameter:
``torch.export`` traces them with the custom op
(``ops/pointnet_infer.py::pointnet_pool_op``) into a serving artifact.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDEncoder, reparametrize
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder, refuse_other_encoders
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_infer import (
    fold_batchnorm,
    folded_pointnet_params,
    pointnet_pool_infer,
    pointnet_pool_ref,
)


# the PointNet stage: (B, T, N, C) and the folded stack -> (B, T, D)
Pool = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def _pool(use_kernel: bool) -> Pool:
    return pointnet_pool_infer if use_kernel else pointnet_pool_ref


def _backbone_eval(encoder: Union[CGEncoder, ORCEDEncoder], x: torch.Tensor,
                   pool: Pool) -> torch.Tensor:
    """``(B, T, N, C) -> (B, filters[-1])`` with BatchNorm folded."""
    refuse_other_encoders(encoder, "open-set inference and serving")
    backbone = encoder.backbone
    folded = folded_pointnet_params(backbone.pointnet)
    h = pool(x.float().contiguous(), folded)  # (B, T, D)

    h = h.transpose(1, 2)  # (B, D, T) for conv1d
    for layer in backbone.tcn.layers:
        conv, bn = layer.conv, layer.norm
        w = conv.weight  # (out, in, k)
        # fold over the output channel: kernel rows are (k·in) wide
        folded_w, folded_b = fold_batchnorm(
            w.reshape(w.shape[0], -1).t(), conv.bias, bn.scale, bn.bias,
            bn.mean, bn.var, bn.eps,
        )
        hp = F.pad(h, (layer.pad, 0))
        h = F.elu(F.conv1d(hp, folded_w.t().reshape(w.shape), folded_b,
                           dilation=layer.dilation))
    return h.mean(dim=2)


@torch.inference_mode()
def fused_encoder_apply(encoder: CGEncoder, x: torch.Tensor, *, use_kernel: bool = True):
    """Eval-mode ``CGEncoder`` forward → ``(logits, sup_fv)``."""
    return encoder_eval(encoder, x, _pool(use_kernel))


def encoder_eval(encoder: CGEncoder, x: torch.Tensor, pool: Pool):
    """``fused_encoder_apply`` with the PointNet stage ``pool``."""
    feats = _backbone_eval(encoder, x, pool)

    def dense_elu(layer, h):
        return F.elu(torch.matmul(h, layer.weight.t()) + layer.bias)

    sup_fv = dense_elu(encoder.MLP_sup1, feats)
    h = sup_fv
    if encoder.use_projection_head:
        h = dense_elu(encoder.MLP_head, h)
    return dense_elu(encoder.MLP_sup2, h), sup_fv


@torch.inference_mode()
def fused_orced_encoder_apply(encoder: ORCEDEncoder, x: torch.Tensor, *,
                              eps: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              use_kernel: bool = True):
    """Eval-mode ``ORCEDEncoder`` forward → ``(logits, z, mu, logvar)``.

    The reparametrization samples in eval too: ``eps`` ``(B, latent)`` is
    used as given, else drawn from ``generator`` on ``x``'s device.
    """
    return orced_encoder_eval(encoder, x, _pool(use_kernel), eps=eps, generator=generator)


def orced_encoder_eval(encoder: ORCEDEncoder, x: torch.Tensor, pool: Pool, *,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
    """``fused_orced_encoder_apply`` with the PointNet stage ``pool``."""
    feats = _backbone_eval(encoder, x, pool)

    def dense(layer, h):
        return torch.matmul(h, layer.weight.t()) + layer.bias

    mu = dense(encoder.MLP_mu, feats)
    logvar = dense(encoder.MLP_logvar, feats)
    z = reparametrize(mu, logvar, eps, generator)
    return dense(encoder.MLP_classification, z), z, mu, logvar
