"""Per-class prior-centroid network.

Port of ``opensetgaitrecognition_pcaa_tpu/models/mean_learner.py:27-37``:
one-hot → 16 → 32 → 64 → latent, with BatchNorm + ELU after each of the
first three dense layers. The JAX module reads its input width from the
one-hots; here it is ``n_classes``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.layers import TorchDense
from opensetgaitrecognition_pcaa_tpu_torch.models.norm import TorchBatchNorm


class GaussianMeanLearner(nn.Module):
    def __init__(self, n_classes: int, latent_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        widths = (16, 32, 64, latent_dim)
        ins = (n_classes,) + widths[:-1]
        self.dense = nn.ModuleList(TorchDense(i, o, gen) for i, o in zip(ins, widths))
        self.norm = nn.ModuleList(TorchBatchNorm(w) for w in widths[:-1])

    def forward(self, onehot: torch.Tensor) -> torch.Tensor:
        h = onehot
        for dense, norm in zip(self.dense, self.norm):
            h = F.elu(norm(dense(h)))
        return self.dense[-1](h)
