"""OR-CED models: the VAE-style encoder and its decoder.

Port of ``opensetgaitrecognition_pcaa_tpu/models/orced.py:24-68``. Kept
quirks:

- the heads ``MLP_mu``, ``MLP_logvar`` and ``MLP_classification`` are plain
  dense layers, with no ELU (unlike ``CGEncoder``'s);
- the reparametrization ``z = mu + eps * exp(0.5 * logvar)`` samples
  ``eps`` in eval mode too, so a caller passes ``eps`` or a
  ``torch.Generator`` to draw it from;
- the decoder is ``CGDecoder``'s 5-layer shape fed by the latent directly.

``compute_dtype`` is taken by the encoder's backbone and by the decoder,
as JAX ``build_orced`` passes it; the heads compute in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.layers import GaitBackbone, TorchDense
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGDecoder


def reparametrize(mu: torch.Tensor, logvar: torch.Tensor, eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mu + eps * exp(0.5 * logvar)``; ``eps`` drawn from ``generator``
    (on ``logvar``'s device) when not given."""
    if eps is None:
        if generator is None:
            raise ValueError("the reparametrization needs eps or a generator")
        eps = torch.randn(logvar.shape, generator=generator, device=logvar.device)
    return mu + eps * torch.exp(0.5 * logvar)


class ORCEDEncoder(nn.Module):
    """``(B, T, N, C)`` → ``(logits, z, mu, logvar)``."""

    def __init__(self, n_out_labels: int, in_features: int = 4, sup_latent_dim: int = 32,
                 pointnet_out_dim: int = 1024,
                 dtc_filters: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.backbone = GaitBackbone(in_features, pointnet_out_dim, dtc_filters, gen,
                                     compute_dtype)
        self.MLP_mu = TorchDense(dtc_filters[-1], sup_latent_dim, gen)
        self.MLP_logvar = TorchDense(dtc_filters[-1], sup_latent_dim, gen)
        self.MLP_classification = TorchDense(sup_latent_dim, n_out_labels, gen)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.heads(self.backbone(x), eps, generator)

    def heads(self, feats: torch.Tensor, eps: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Backbone features ``(B, filters[-1])`` → ``(logits, z, mu, logvar)``."""
        mu = self.MLP_mu(feats)
        logvar = self.MLP_logvar(feats)
        z = reparametrize(mu, logvar, eps, generator)
        return self.MLP_classification(z), z, mu, logvar


class ORCEDDecoder(CGDecoder):
    """Latent ``(B, sup_latent_dim)`` → reconstruction ``(B, T, N, C)``."""
