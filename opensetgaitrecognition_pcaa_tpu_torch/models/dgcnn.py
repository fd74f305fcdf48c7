"""The DGCNN encoder of PCAA V4 (Wang, Sun, Liu, Sarma, Bronstein and
Solomon, "Dynamic Graph CNN for Learning on Point Clouds", ACM TOG 2019,
arXiv 1801.07829; github.com/WangYueFt/dgcnn ``pytorch/model.py``, class
``DGCNN``, the classification settings). No JAX module corresponds: the JAX
package has no DGCNN.

The contract, which the program and the plain references follow
(``benchmark/reference/pcaa_v4_dgcnn.py``):

- Per frame, on ``(B·T, N, C)``: the crop's frames are the point clouds.
- EdgeConv layers of widths (64, 64, 128, 256). The graph of every layer is
  the kNN on that layer's whole input, layer 1's on all the input channels
  (``get_graph_feature`` takes its whole input): the distance ``Σ_c (x_ic −
  x_jc)²`` summed in channel order in f32, each operation rounded on its own
  (no contraction), the point itself included, ties to the lower index,
  ``k_eff = min(k, N)`` neighbours (``ops/dgcnn_knn.py``). The graph is a
  submodule of each layer (``KNNGraph``) whose forward returns the indices.
- The edge feature ``[x_j − x_i, x_i]`` through the bias-free 1×1 conv ``W =
  [W_a | W_b]`` ``(O, 2·C)``: ``h_ij = W_a·(x_j − x_i) + W_b·x_i``, formed
  as ``A_i + B_j`` from the per-point products ``A = (W_b − W_a)·x`` and
  ``B = W_a·x`` (cuBLAS in f32); then BatchNorm over all ``B·T·N·k_eff``
  edges, LeakyReLU(0.2) and the max over the neighbours, computed as
  ``y_ic = LeakyReLU(s_c·(ext_j h_ijc − μ_c) + β_c)``, ``s_c = γ_c / √(σ²_c
  + eps)``, the max where ``s_c ≥ 0`` and the min where ``s_c < 0``, which
  is exact: BatchNorm's affine map and LeakyReLU are monotone in each
  channel (``ops/dgcnn_edge.py``). BatchNorm is ``models/norm.py::
  TorchBatchNorm``'s: biased variance for the batch, the running estimates
  moved by momentum 0.1 towards the mean and the unbiased variance with n
  the edges counted; eval mode uses the running estimates.
- ``conv5``: bias-free 512 → 1024 over the concatenated layer outputs, BN
  over the points, LeakyReLU; then ``[max over N ‖ mean over N]``, 2048
  features a frame, padded duplicate points counted as they lie.
- Then V4's TCN from 2048 channels (``models/layers.py::
  TemporalConvBlock``), the mean over time and PCAA's heads
  (``CGEncoder.heads``), in place of DGCNN's classifier MLP and dropout.

On the card the graph and the edge pass are the hand-written kernels
(``csrc/dgcnn_knn.cu``, ``csrc/dgcnn_edge.cu``), which never hold a ``(B·T,
N, k, C)`` tensor of the edges; the products, ``conv5``, its BN and the
pooling are plain PyTorch.

Spans (``utils/profiling.py``), under the trainer's ``train.encoder``:
``dgcnn.edgeconv`` ⊃ per layer (``dgcnn.knn``, ``dgcnn.product``,
``dgcnn.edge``), then ``dgcnn.point`` (``conv5``, its BN and the pooling);
the counter ``dgcnn.edges`` (``B·T·N·k_eff`` a layer and forward). They hold
the forward's launches; the backward runs under ``train.backward``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.layers import (
    TemporalConvBlock,
    TorchDense,
    _uniform_,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.norm import TorchBatchNorm
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_edge import MAX_K, edge_conv
from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_knn import MAX_POINTS, dgcnn_knn
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class DGCNNSpec:
    """The encoder's sizes; the defaults are the published classification
    settings."""

    title: ClassVar[str] = "DGCNN"
    k: int = 20
    widths: Tuple[int, ...] = (64, 64, 128, 256)
    emb_dims: int = 1024
    slope: float = 0.2
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1

    def check(self, n_points: int) -> None:
        """``ValueError`` where the index types cannot hold the graph: a
        one-byte slot holds 256 neighbours, and the kernels take at most
        ``MAX_POINTS`` points a frame."""
        if not 1 <= self.k <= MAX_K:
            raise ValueError(f"k = {self.k}: the edge pass's one-byte slot holds 1 to {MAX_K} "
                             f"neighbours")
        if not 1 <= n_points <= MAX_POINTS:
            raise ValueError(f"{n_points} points a frame: the DGCNN kernels take 1 to "
                             f"{MAX_POINTS}")


class KNNGraph(nn.Module):
    """``(F, N, C)`` features → ``(F, N, min(k, N))`` int64 neighbour
    indices, nearest first; no gradient."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return dgcnn_knn(h.detach(), self.k)


class EdgeConvLayer(nn.Module):
    """One EdgeConv layer: the graph, the conv's weight ``(O, 2·C)`` (the
    published ``Conv2d(2·C, O, 1, bias=False)``'s) and its BatchNorm."""

    def __init__(self, c_in: int, c_out: int, spec: DGCNNSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.graph = KNNGraph(spec.k)
        self.weight = nn.Parameter(torch.empty(c_out, 2 * c_in))
        _uniform_(self.weight, 2 * c_in, generator)
        self.norm = TorchBatchNorm(c_out, momentum=spec.bn_momentum, eps=spec.bn_eps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        c = h.shape[-1]
        with span("dgcnn.knn"):
            idx = self.graph(h)
        with span("dgcnn.product"):
            w_a, w_b = self.weight[:, :c], self.weight[:, c:]
            ab = F.linear(h, torch.cat([w_b - w_a, w_a]))                  # (F, N, 2·O): [A | B]
        with span("dgcnn.edge"):
            norm = self.norm
            y, mean, var = edge_conv(ab, idx, norm.scale, norm.bias, norm.mean, norm.var,
                                     self.training, norm.eps, self.spec.slope)
            if self.training:  # n the edges counted
                norm.update_running(mean, var, idx.numel())
        count("dgcnn.edges", idx.numel())
        return y


class DGCNNEncoder(nn.Module):
    """``(B, T, N, C) → (out_classes, sup_fv)``, the interface of
    ``CGEncoder``: the module docstring's EdgeConv layers, ``conv5`` and the
    pooling per frame, then V4's TCN, the mean over time and PCAA's heads."""

    def __init__(self, n_out_labels: int, spec: DGCNNSpec = DGCNNSpec(), in_features: int = 4,
                 sup_latent_dim: int = 32,
                 dtc_filters: Tuple[int, ...] = (16, 32, 64, 128, 256, 512),
                 use_projection_head: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.spec = spec
        self.use_projection_head = use_projection_head
        ins = (in_features,) + tuple(spec.widths[:-1])
        self.edges = nn.ModuleList(EdgeConvLayer(i, o, spec, gen)
                                   for i, o in zip(ins, spec.widths))
        self.conv5 = nn.Linear(sum(spec.widths), spec.emb_dims, bias=False)
        _uniform_(self.conv5.weight, sum(spec.widths), gen)
        self.bn5 = TorchBatchNorm(spec.emb_dims, momentum=spec.bn_momentum, eps=spec.bn_eps)
        self.tcn = TemporalConvBlock(2 * spec.emb_dims, tuple(dtc_filters), generator=gen)
        self.MLP_sup1 = TorchDense(dtc_filters[-1], sup_latent_dim, gen)
        head_out = sup_latent_dim
        if use_projection_head:
            head_out = sup_latent_dim // 2
            self.MLP_head = TorchDense(sup_latent_dim, head_out, gen)
        self.MLP_sup2 = TorchDense(head_out, n_out_labels, gen)

    def forward(self, x: torch.Tensor):
        return self.heads(self.features(x))

    heads = CGEncoder.heads  # the same layers under the same names

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, N, C) → (B, filters[-1])``."""
        b, t_len, n, c = x.shape
        h = x.float().reshape(b * t_len, n, c).contiguous()
        ys = []
        with span("dgcnn.edgeconv"):
            for layer in self.edges:
                h = layer(h)
                ys.append(h)
        with span("dgcnn.point"):
            h = F.leaky_relu(self.bn5(F.linear(torch.cat(ys, dim=-1), self.conv5.weight)),
                             self.spec.slope)
            pooled = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        return self.tcn(pooled.reshape(b, t_len, -1)).mean(dim=1)
