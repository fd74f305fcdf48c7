"""The P4Transformer encoder of PCAA V4 (Fan, Yang and Kankanhalli, "Point
4D Transformer Networks for Spatio-Temporal Modeling in Point Cloud
Videos", CVPR 2021; github.com/hehefan/P4Transformer ``models/msr.py``,
``modules/point_4d_convolution.py``, ``modules/transformer.py``). No JAX
module corresponds: the JAX package has no P4Transformer.

The contract, which the program and the plain references follow
(``tests/p4t_reference.py``, ``benchmark/reference/pcaa_v4_p4t.py``):

- Input: the crop ``x (B, T, N, 4)``, channels-last; ``p = x[..., :3]`` the
  positions, ``f = x[..., 3:4]`` the Doppler.
- Tube embedding (P4DConv, ``operator '+'``, max pooling in space and
  time). The frames are padded in front by repeating frame 0
  (``temporal_padding`` [1, 0], replicate); the output frames are padded
  indices t = 1, 3, …, T − 1 (temporal kernel 3, stride 2): L = 15 at T = 30.
  Anchors: farthest-point sampling of M = N // spatial_stride points of
  frame t, from index 0, each next anchor the point of the largest squared
  distance to its nearest chosen anchor (the minimum over every point,
  chosen ones included), ties to the lowest index. For each frame i ∈ {t −
  1, t, t + 1} and anchor a, the ball query on frame i: the first K indices
  j, ascending, with ``|p_j − a|² < r²``, the slots left filled with the
  first index found, or 0 where none is. Squared distances are ``((dx·dx +
  dy·dy) + dz·dz)`` in f32, each operation rounded on its own
  (``ops/p4t_group.py``). Each sample's feature is ``W_d·(p_j − a, i − t) +
  W_f·f_j`` (``W_d`` D×4, ``W_f`` D×1, no bias, norm or activation); the
  token takes the max over the K samples, then over the 3 frames
  (``ops/p4t_tube.py``).
- Tokens are frame-major, L × M = 1,125 a crop at the published sizes. The
  position embedding is ``W_p·(a, τ + 1) + b_p`` (4 → D, τ = 0..L − 1); the
  embedding is feature + position, with no ReLU (``emb_relu`` off, as
  published).
- ``depth`` pre-norm blocks: ``x = x + GELU(W_o·MHA(LN₁(x)) + b_o)``, then
  ``x = x + GELU(W₂·GELU(W₁·LN₂(x) + b₁) + b₂)``; MHA from one bias-free
  D → 3·heads·dim_head map (q, k, v in that order, heads of ``dim_head``),
  ``softmax(q·kᵀ/√dim_head)·v``, no mask; LayerNorm eps 1e-5; GELU exact
  (erf). The GELUs after ``W_o`` and ``W₂`` are P4Transformer's.
- Output: the max over the tokens (``amax``: tied tokens, which a frame
  padded by repeated points gives, are identical rows and share the
  gradient evenly, which leaves every weight's gradient as a single
  token's would), then P4Transformer's head LayerNorm (D). PCAA's heads
  follow unchanged (``CGEncoder.heads``): ``MLP_sup1`` D → latent + ELU
  (``sup_fv``), ``MLP_head`` latent → latent/2 + ELU, ``MLP_sup2`` → n +
  ELU, in place of P4Transformer's class MLP and dropout.

Departures from the published MSR-Action3D model: M = N // 2 anchors
(spatial stride 2, where 2048 points take stride 32: a radar frame holds
150); the Doppler as the one input feature (``in_planes`` 1, P4DConv's own
``conv_f`` with ``operator '+'``) where MSR-Action3D has none; PCAA's heads;
the radius 0.7 kept in metres on centred crops.

On the card, farthest-point sampling, the ball query and the tube are the
hand-written kernels (``csrc/p4t_group.cu``, ``csrc/p4t_tube.cu``), and so
are the blocks' dense products (``to_qkv``, ``to_out``, ``ff1``, ``ff2``,
forward and both gradients: ``ops/p4t_linear.py`` → ``csrc/p4t_linear.cu``,
on the tensor cores in the exact three-pass TF32 mode of the PointNet
kernels, f32-accurate where single-pass TF32 stays off,
``infer/common.py::ieee_f32``), and so is attention, forward and backward
(``ops/p4t_attention.py`` → ``csrc/p4t_attention.cu``: flash attention in
the same three-pass mode, which never holds the ``(B, heads, tokens,
tokens)`` scores); the rest of the transformer is plain PyTorch: LayerNorm
and GELU. On the CPU the dense products are ``F.linear`` and attention is
``F.scaled_dot_product_attention``.

Spans (``utils/profiling.py``), under the trainer's ``train.encoder``:
``p4t.embed`` ⊃ (``p4t.fps``, ``p4t.ball_query``, ``p4t.tube``,
``p4t.position``), then ``p4t.transformer``; the counter ``p4t.tokens``
(B·L·M a forward). They hold the forward's launches; the backward runs
under the trainer's ``train.backward``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.models.layers import TorchDense, _uniform_
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_attention import p4t_attention
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_group import ball_query, furthest_point_sample
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_linear import p4t_linear
from opensetgaitrecognition_pcaa_tpu_torch.ops.p4t_tube import MAX_SAMPLES, tube_embed
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, span

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class P4TSpec:
    """The encoder's sizes; the defaults are the published MSR-Action3D
    settings (``spatial_stride`` 2 for a 150-point radar frame, the module
    docstring)."""

    title: ClassVar[str] = "P4Transformer"
    radius: float = 0.7
    nsamples: int = 32
    spatial_stride: int = 2
    temporal_kernel: int = 3
    temporal_stride: int = 2
    temporal_padding: Tuple[int, int] = (1, 0)
    dim: int = 1024
    depth: int = 5
    heads: int = 8
    dim_head: int = 128
    mlp_dim: int = 2048

    def frames(self, t_len: int) -> int:
        """L, the output frames of a ``t_len``-frame crop; ``ValueError``
        where the padded frames do not step evenly (P4DConv's assertion) or
        a padding reaches past the kernel's half."""
        kt, st = self.temporal_kernel, self.temporal_stride
        pad0, pad1 = self.temporal_padding
        if kt % 2 == 0 or max(pad0, pad1) > kt // 2:
            raise ValueError(f"temporal kernel {kt} with padding {self.temporal_padding}: the "
                             f"kernel must be odd and each padding at most its half")
        padded = t_len + pad0 + pad1
        if padded < kt or (padded - kt) % st:
            raise ValueError(f"{t_len} frames padded by {self.temporal_padding} do not step by "
                             f"{st} with kernel {kt}")
        return (padded - kt) // st + 1

    def anchors(self, n_points: int) -> int:
        """M, the anchors of an ``n_points``-point frame."""
        m = n_points // self.spatial_stride
        if m < 1:
            raise ValueError(f"{n_points} points give no anchor at spatial stride "
                             f"{self.spatial_stride}")
        return m


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class Block(nn.Module):
    """One pre-norm block of P4Transformer's ``Transformer``."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: torch.Generator):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = _layer_norm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        _uniform_(self.to_qkv.weight, dim, generator)
        self.to_out = TorchDense(inner, dim, generator)
        self.norm2 = _layer_norm(dim)
        self.ff1 = TorchDense(dim, mlp_dim, generator)
        self.ff2 = TorchDense(mlp_dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = p4t_linear(self.norm1(x), self.to_qkv.weight)          # (B, n, 3·heads·dh)
        a = p4t_attention(qkv, self.heads, self.dim_head)             # (B, n, heads·dh)
        # p4t_linear in place of each layer's forward, which is F.linear at
        # the f32 and single device the encoder trains at
        x = x + F.gelu(p4t_linear(a, self.to_out.weight, self.to_out.bias))
        h = F.gelu(p4t_linear(self.norm2(x), self.ff1.weight, self.ff1.bias))
        return x + F.gelu(p4t_linear(h, self.ff2.weight, self.ff2.bias))


class Tube(nn.Module):
    """P4DConv's bias-free ``conv_d`` (D×4) and ``conv_f`` (D×1) weights."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.conv_d = nn.Parameter(torch.empty(dim, 4))
        self.conv_f = nn.Parameter(torch.empty(dim, 1))
        _uniform_(self.conv_d, 4, generator)
        _uniform_(self.conv_f, 1, generator)


class P4TEncoder(nn.Module):
    """``(B, T, N, 4) → (out_classes, sup_fv)``, the interface of
    ``CGEncoder``: the module docstring's tube embedding, position
    embedding, transformer, max over tokens and head LayerNorm, then PCAA's
    heads."""

    def __init__(self, n_out_labels: int, spec: P4TSpec = P4TSpec(),
                 sup_latent_dim: int = 32, use_projection_head: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        if spec.temporal_kernel * spec.nsamples > MAX_SAMPLES:
            raise ValueError(f"{spec.temporal_kernel} x {spec.nsamples} samples a token; the "
                             f"tube holds at most {MAX_SAMPLES}")
        self.spec = spec
        self.use_projection_head = use_projection_head
        self.tube = Tube(spec.dim, gen)
        self.pos_embedding = TorchDense(4, spec.dim, gen)
        self.transformer = nn.ModuleList(
            Block(spec.dim, spec.heads, spec.dim_head, spec.mlp_dim, gen)
            for _ in range(spec.depth))
        self.norm = _layer_norm(spec.dim)
        self.MLP_sup1 = TorchDense(spec.dim, sup_latent_dim, gen)
        head_out = sup_latent_dim
        if use_projection_head:
            head_out = sup_latent_dim // 2
            self.MLP_head = TorchDense(sup_latent_dim, head_out, gen)
        self.MLP_sup2 = TorchDense(head_out, n_out_labels, gen)

    def forward(self, x: torch.Tensor):
        return self.heads(self.features(x))

    heads = CGEncoder.heads  # the same layers under the same names

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, N, 4) → (B, L·M, D)`` tokens, frame-major."""
        s = self.spec
        b, t_len, n, c = x.shape
        if c != 4:
            raise ValueError(f"the P4Transformer encoder takes (x, y, z, Doppler) points, got "
                             f"{c} channels")
        l_len, m = s.frames(t_len), s.anchors(n)
        kt, st, pad = s.temporal_kernel, s.temporal_stride, s.temporal_padding[0]
        x = x.contiguous()
        first = kt // 2 - pad
        frames = x[:, first:first + st * (l_len - 1) + 1:st]          # (B, L, N, 4) anchor frames
        with span("p4t.fps"):
            anchor = furthest_point_sample(frames, m)
        with span("p4t.ball_query"):
            ball = ball_query(x, anchor, s.radius, s.nsamples, kt, st, pad)
        with span("p4t.tube"):
            feat = tube_embed(x, anchor, ball, self.tube.conv_d, self.tube.conv_f, kt, st, pad)
        with span("p4t.position"):
            a = torch.gather(frames[..., :3], 2, anchor[..., None].expand(-1, -1, -1, 3))
            tau = torch.arange(1, l_len + 1, device=x.device, dtype=x.dtype)
            xyzt = torch.cat([a, tau[None, :, None, None].expand(b, l_len, m, 1)], dim=-1)
            pos = self.pos_embedding(xyzt)
        count("p4t.tokens", b * l_len * m)
        return (feat + pos).reshape(b, l_len * m, s.dim)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, N, 4) → (B, D)``: the tokens through the transformer, the
        max over tokens and the head LayerNorm."""
        with span("p4t.embed"):
            h = self.embed(x)
        with span("p4t.transformer"):
            for block in self.transformer:
                h = block(h)
        return self.norm(h.amax(dim=1))

