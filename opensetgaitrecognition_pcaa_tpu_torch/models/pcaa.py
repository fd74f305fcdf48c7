"""PCAA models: the encoder, the decoder, the critic and the projection head.

Port of ``opensetgaitrecognition_pcaa_tpu/models/pcaa.py:26-114``. Kept
quirks:

- ELU on the classification logits, and the encoder's projection head
  ``MLP_head`` (latent → latent/2) between the latent and the classifier,
  present for V1 and V4;
- the decoder has 5 dense layers S/16 → S/8 → S/4 → S/2 → S with
  S = T·C·NMAX, ELU between them, no norm, no output activation, and its
  flat output reshaped channels-last to ``(B, T, N, C)``;
- the critic is ``concat(z, onehot)`` → 64 → 32 → 1 with ELU between;
- a projection head is one dense layer + ELU (the V4 decoder head is
  latent → 2·latent).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.layers import GaitBackbone, TorchDense


class CGEncoder(nn.Module):
    """``(B, T, N, C) -> (out_classes, sup_fv)``; ``sup_fv`` is the latent
    before the projection head."""

    def __init__(self, n_out_labels: int, in_features: int = 4,
                 sup_latent_dim: int = 32, pointnet_out_dim: int = 1024,
                 dtc_filters: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 use_projection_head: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.use_projection_head = use_projection_head
        self.backbone = GaitBackbone(in_features, pointnet_out_dim, dtc_filters, gen)
        self.MLP_sup1 = TorchDense(dtc_filters[-1], sup_latent_dim, gen)
        head_out = sup_latent_dim
        if use_projection_head:
            head_out = sup_latent_dim // 2
            self.MLP_head = TorchDense(sup_latent_dim, head_out, gen)
        self.MLP_sup2 = TorchDense(head_out, n_out_labels, gen)

    def forward(self, x: torch.Tensor):
        return self.heads(self.backbone(x))

    def heads(self, feats: torch.Tensor):
        """Backbone features ``(B, filters[-1])`` → ``(out_classes, sup_fv)``."""
        sup_fv = F.elu(self.MLP_sup1(feats))
        h = sup_fv
        if self.use_projection_head:
            h = F.elu(self.MLP_head(h))
        return F.elu(self.MLP_sup2(h)), sup_fv


class CGDecoder(nn.Module):
    """Latent ``(B, in_features)`` → reconstruction ``(B, T, N, C)``."""

    def __init__(self, in_features: int, nsteps: int = 30, nmax_points: int = 150,
                 nfeatures: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.shape = (nsteps, nmax_points, nfeatures)
        size = nsteps * nfeatures * nmax_points
        widths = (size // 16, size // 8, size // 4, size // 2, size)
        ins = (in_features,) + widths[:-1]
        self.dense = nn.ModuleList(TorchDense(i, o, gen) for i, o in zip(ins, widths))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            z = F.elu(layer(z))
        z = self.dense[-1](z)
        return z.reshape((z.shape[0],) + self.shape)


class CGDiscriminator(nn.Module):
    """Conditional WGAN critic: ``(z, onehot)`` → ``(B, 1)`` logit."""

    def __init__(self, latent_dim: int, n_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        ins, outs = (latent_dim + n_classes, 64, 32), (64, 32, 1)
        self.dense = nn.ModuleList(TorchDense(i, o, gen) for i, o in zip(ins, outs))

    def forward(self, z: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        h = torch.cat([z, onehot], dim=-1)
        h = F.elu(self.dense[0](h))
        h = F.elu(self.dense[1](h))
        return self.dense[2](h)


class ProjectionHead(nn.Module):
    """One dense layer + ELU."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = TorchDense(in_features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.dense(x))
