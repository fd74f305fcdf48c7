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
accumulation" is the JAX package's arithmetic up to the order of the sums
whichever GEMM computes it. A bf16 ``dense`` runs ``Bf16Dense``, whose
GEMMs forward and backward are ``ops/pointnet_train.py::mm_bf16``'s
(cuBLAS's bf16 GEMM with an f32 result on the card, so that the weights
are read as bf16; an f32 GEMM of the bf16 values on the CPU), with JAX's
roundings: the cotangent of a bf16 operand is rounded to bf16 and then
upcast (``tests/test_torch_weight_cache.py`` holds it to autograd through
``round_bf16`` casts).

``TorchDense.weight_bf16`` (None unless a trainer sets it) is a bf16 copy
of the layer's weight, the decoder's weight cache of
``Config.BF16_WEIGHT_CACHE`` (JAX ``train/pcaa.py::_cache_tree``): a bf16
layer then reads the copy instead of rounding its f32 weight, and the
gradient lands on the copy, in bf16. Both paths round the same weight to
the same bf16 values and take the same GEMM, so the copy changes the bytes
moved and not one bit of the result.

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


class Bf16Dense(torch.autograd.Function):
    """``(x @ W^T + b)`` rounded to bf16, with bf16 operands and f32
    accumulation: JAX ``TorchDense`` at bf16. ``weight`` is the f32 master or
    its bf16 copy; its gradient comes back in its own dtype (the bf16
    rounding of the f32 product, upcast for the master), the input's
    likewise rounded to bf16 first, the bias's is the f32 sum of the
    upcast cotangent, as JAX's transposes of the casts and the dot give
    them. The GEMMs are ``mm_bf16``'s (on the CPU, f32 GEMMs of the bf16
    values)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import mm_bf16

        x16 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        w16 = weight.to(torch.bfloat16)
        ctx.save_for_backward(x16, w16)
        ctx.dtypes, ctx.shape = (x.dtype, weight.dtype), x.shape
        y = mm_bf16(x16, w16.t()) + bias
        return y.to(torch.bfloat16).reshape(x.shape[:-1] + (weight.shape[0],))

    @staticmethod
    def backward(ctx, gy):
        from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import mm_bf16

        x16, w16 = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        g16 = gy.reshape(-1, gy.shape[-1]).to(torch.bfloat16)
        gx = mm_bf16(g16, w16).to(torch.bfloat16).to(x_dtype).reshape(ctx.shape)
        gw = mm_bf16(g16.t(), x16).to(torch.bfloat16).to(w_dtype)
        gb = g16.float().sum(dim=0)
        return gx, gw, gb


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          weight_bf16: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX ``TorchDense`` at ``compute_dtype``; ``weight`` is ``(out, in)``.
    At bf16, ``weight_bf16`` (a bf16 copy of ``weight``) is read in its
    place (the module docstring)."""
    if compute_dtype == torch.float32:
        return F.linear(x, weight, bias)
    return Bf16Dense.apply(x, weight if weight_bf16 is None else weight_bf16, bias)


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
        self.weight_bf16: Optional[torch.Tensor] = None  # the module docstring
        gen = generator or torch.Generator().manual_seed(0)
        _uniform_(self.weight, in_features, gen)
        _uniform_(self.bias, in_features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias if self.mesh is None else _shard_rows(self.bias, self.weight, self.mesh)
        y = dense(x, self.weight, bias, self.compute_dtype, self.weight_bf16)
        return y if self.mesh is None else self.mesh.gather_model(y, dim=-1)


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
