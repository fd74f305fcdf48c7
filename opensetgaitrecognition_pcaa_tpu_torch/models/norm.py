"""BatchNorm with the JAX package's (and torch's BatchNorm) semantics over
the trailing channel axis.

Port of ``opensetgaitrecognition_pcaa_tpu/models/norm.py:25-62``. In train
mode the batch is normalized with the biased variance over every axis but
the last, and the running estimates move by momentum 0.1 towards the batch
mean and the UNBIASED batch variance. In eval mode the running estimates
are used. Channels-last, so one module covers BatchNorm over (B, T, N),
(B, T) and (B,).

Parameter names follow the JAX tree: ``scale``/``bias`` parameters and
``mean``/``var`` buffers (its ``batch_stats``).

Under data parallelism (``mesh``, set by ``parallel/mesh.py::
shard_modules``) a batch's rows lie on the ranks of the data group, and the
train-mode statistics are the global batch's, as GSPMD computes them: the
sums of the two passes are all-reduced over the group (differentiably: the
backward sums the cotangents over it too), the means taken with the global
count, and the running estimates move with it.
"""

from __future__ import annotations

import torch
from torch import nn


class TorchBatchNorm(nn.Module):
    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            n = xf.numel() // xf.shape[-1]
            if self.mesh is None or self.mesh.dp == 1:
                mean = xf.mean(dim=dims)
                var = ((xf - mean) ** 2).mean(dim=dims)
            else:
                n *= self.mesh.dp
                mean = self.mesh.sum_data(xf.sum(dim=dims)) / n
                var = self.mesh.sum_data(((xf - mean) ** 2).sum(dim=dims)) / n
            self.update_running(mean, var, n)
        else:
            mean, var = self.mean, self.var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        return ((xf - mean) * (inv * self.scale) + self.bias).to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Move the running estimates by the momentum towards a batch's mean
        and the unbiased variance of its ``n`` samples (``var`` biased)."""
        m = self.momentum
        unbiased = var * (n / max(n - 1, 1))
        self.mean.copy_((1.0 - m) * self.mean + m * mean)
        self.var.copy_((1.0 - m) * self.var + m * unbiased)
