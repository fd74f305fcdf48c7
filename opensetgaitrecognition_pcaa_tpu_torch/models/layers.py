"""Shared backbone layers: per-point MLP stack + causal dilated TCN.

Port of ``opensetgaitrecognition_pcaa_tpu/models/layers.py:52-171``. Every
public ``forward`` is channels-last, as in the JAX package: the PointNet
takes ``(B, T, N, C)``, the TCN ``(B, T, C)``.

Each layer takes a ``compute_dtype`` (the JAX modules' ``dtype``): float32
by default, or bfloat16, with the JAX package's casts module by module
(``torch.autocast`` rounds elsewhere). Parameters and BatchNorm statistics
stay f32 either way. At bf16:

- ``TorchDense``: the operand and the kernel are rounded to bf16, the
  product accumulates in f32, the f32 bias is added to the f32 sum, and
  only then is the result rounded to bf16 (JAX ``layers.py:58-72``);
- ``CausalDilatedConv1d``: flax ``nn.Conv(dtype=bf16)``: input, kernel and
  bias rounded to bf16, the convolution's output rounded to bf16, then the
  bias added in bf16; BatchNorm and ELU run on the bf16 values;
- activations travel in bf16 between the layers, and ELU on a bf16 tensor
  is ``jax.nn.elu``'s formula (``elu``), so that its backward rounds where
  JAX's does; the backbone's two means are taken in f32.

A product of two bf16 values is exact in f32, so "bf16 operands, f32
accumulation" is computed as an f32 GEMM of bf16-rounded operands
(``round_bf16``): the JAX package's arithmetic up to the order of the
sums, on the CPU and the card alike (TF32 is off, ``infer/common.py::
ieee_f32``). Autograd through the casts gives JAX's gradients too: the
cotangent of a bf16 operand is rounded to bf16 and then upcast.

Under tensor parallelism (``mesh``, set by ``parallel/mesh.py::
shard_modules`` on a layer whose kernel the model group shards) the
layer holds the rows ``[m·out/MP, (m+1)·out/MP)`` of its weight, computes
those output columns with the matching block of its replicated bias, and
all-gathers the columns over the model group (whose backward is the
reduce-scatter-sum of the cotangents).

Weights start from torch's default init, U(±1/√fan_in) for kernel and
bias, drawn from an explicit ``torch.Generator``; a run folder's weights
replace them through ``convert.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.norm import TorchBatchNorm


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and held in f32."""
    return t.to(torch.bfloat16).float()


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """JAX ``TorchDense`` at ``compute_dtype``; ``weight`` is ``(out, in)``."""
    if compute_dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(round_bf16(x), round_bf16(weight), bias).to(compute_dtype)


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU. At f32, ``F.elu``; at bf16, ``jax.nn.elu``'s formula
    ``where(x > 0, x, expm1(where(x > 0, 0, x)))`` in bf16, whose backward
    ``g·(expm1(x) + 1)`` rounds to bf16 as JAX's does."""
    if x.dtype == torch.float32:
        return F.elu(x)
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, 0.0, x)))


def _uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    if t.is_meta:  # a module built on the meta device for its shapes holds no values
        return
    bound = 1.0 / fan_in**0.5
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


class TorchDense(nn.Linear):
    """``nn.Linear`` (weight ``(out, in)``) with a generator-driven init,
    computing at ``compute_dtype`` (``dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.mesh = None
        gen = generator or torch.Generator().manual_seed(0)
        _uniform_(self.weight, in_features, gen)
        _uniform_(self.bias, in_features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return dense(x, self.weight, self.bias, self.compute_dtype)
        y = dense(x, self.weight, _shard_rows(self.bias, self.weight, self.mesh),
                  self.compute_dtype)
        return self.mesh.gather_model(y, dim=-1)


def _shard_rows(full: torch.Tensor, shard: torch.Tensor, mesh) -> torch.Tensor:
    """The block of the replicated vector ``full`` that matches a model
    rank's ``shard`` of a kernel's output rows."""
    n = shard.shape[0]
    return full[mesh.model_rank * n:(mesh.model_rank + 1) * n]


class PointNetBlock(nn.Module):
    """4 stacked per-point (Dense + BN + ELU) layers, C → D/2 → D/2 → D → D.

    ``(B, T, N, C) -> (B, T, N, D)``."""

    def __init__(self, in_features: int, out_dim: int = 1024,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = (out_dim // 2, out_dim // 2, out_dim, out_dim)
        ins = (in_features,) + widths[:-1]
        self.dense = nn.ModuleList(
            TorchDense(i, o, generator, compute_dtype) for i, o in zip(ins, widths)
        )
        self.norm = nn.ModuleList(TorchBatchNorm(o) for o in widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, norm in zip(self.dense, self.norm):
            x = elu(norm(dense(x)))
        return x


class CausalDilatedConv1d(nn.Module):
    """Causal dilated conv + BN + ELU over ``(B, T, C)``: a left pad of
    ``(k-1)·dilation`` zeros, then a VALID conv."""

    def __init__(self, in_features: int, features: int, dilation: int,
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mesh = None
        self.dilation = dilation
        self.pad = (kernel_size - 1) * dilation
        self.conv = nn.Conv1d(in_features, features, kernel_size, dilation=dilation)
        gen = generator or torch.Generator().manual_seed(0)
        _uniform_(self.conv.weight, in_features * kernel_size, gen)
        _uniform_(self.conv.bias, in_features * kernel_size, gen)
        self.norm = TorchBatchNorm(features)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``compute_dtype`` overrides the module's for this call."""
        dtype = compute_dtype or self.compute_dtype
        h = F.pad(x.transpose(1, 2), (self.pad, 0))  # (B, C, pad + T)
        weight, bias = self.conv.weight, self.conv.bias
        if self.mesh is not None:  # this rank's output channels, gathered below
            bias = _shard_rows(bias, weight, self.mesh)
        if dtype == torch.float32:
            h = F.conv1d(h, weight, bias, dilation=self.dilation)
        else:
            h = F.conv1d(round_bf16(h), round_bf16(weight), dilation=self.dilation)
            h = h.to(dtype) + bias.to(dtype)[:, None]
        if self.mesh is not None:
            h = self.mesh.gather_model(h, dim=1)
        return elu(self.norm(h.transpose(1, 2)))  # (B, T, features)


class TemporalConvBlock(nn.Module):
    """Stacked causal dilated convs, dilations (1,2,4,1,2,4), kernel 3."""

    def __init__(self, in_features: int,
                 filters: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dilations: Sequence[int] = (1, 2, 4, 1, 2, 4),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_features,) + tuple(filters[:-1])
        self.layers = nn.ModuleList(
            CausalDilatedConv1d(i, f, d, generator=generator, compute_dtype=compute_dtype)
            for i, f, d in zip(ins, filters, dilations)
        )

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``compute_dtype`` overrides the modules' for this call."""
        for layer in self.layers:
            x = layer(x, compute_dtype)
        return x


class GaitBackbone(nn.Module):
    """PointNet stack → mean over points → TCN → mean over time.

    ``(B, T, N, C) -> (B, filters[-1])``, pooling in f32."""

    def __init__(self, in_features: int, pointnet_out_dim: int = 1024,
                 filters: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pointnet = PointNetBlock(in_features, pointnet_out_dim, generator, compute_dtype)
        self.tcn = TemporalConvBlock(pointnet_out_dim, filters, generator=generator,
                                     compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pointnet(x).float().mean(dim=2)  # (B, T, D)
        return self.tcn(h).float().mean(dim=1)
