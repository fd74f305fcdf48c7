"""Train-mode ``CGEncoder`` forward through the fused PointNet.

Port of ``opensetgaitrecognition_pcaa_tpu/train/fused_encoder.py:47-131``:
the same function as ``encoder(x)`` in train mode, with the per-point MLP
stack and the point pooling routed through ``ops/pointnet_train.py`` (the
CUDA kernels on the card). Then, as in the JAX package:

- each PointNet BatchNorm's running statistics move by momentum 0.1
  towards the batch mean and the unbiased batch variance, n = B·T·N rows;
- the causal dilated TCN runs in train mode (``F.conv1d``; TF32 is off
  once ``infer/common.py::ieee_f32`` has run) and updates its own running
  statistics, n = B·T. It runs in f32 whatever the encoder's
  ``compute_dtype``: the JAX function calls ``conv_general_dilated`` on
  the f32 pooled tensor with the f32 parameters, no cast;
- the mean over time and the heads.

The running statistics are updated in place on the encoder's buffers.
Under data or tensor parallelism (``mesh``, ``parallel/mesh.py``) x holds
this data rank's rows, the statistics are the global batch's and n counts
its rows; a PointNet layer whose kernel the model group shards passes its
column shard (``ops/pointnet_train.py``), and the TCN and the heads take
the mesh from their modules.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import pointnet_pool_train
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import Mesh


def fused_train_encoder_apply(encoder: CGEncoder, x: torch.Tensor,
                              store_dtype: torch.dtype = torch.float32,
                              mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward ``(B, T, N, C) → (logits, sup_fv)``; the PointNet
    stores its activations in ``store_dtype`` (bf16 under bf16 compute,
    ``ops/pointnet_train.py``); ``mesh`` as in the module docstring."""
    b, t, n, _ = x.shape
    pointnet = encoder.backbone.pointnet
    params = tuple(
        (dense.weight.t(), dense.bias, norm.scale, norm.bias)
        for dense, norm in zip(pointnet.dense, pointnet.norm)
    )
    pooled, means, variances = pointnet_pool_train(x, params, store_dtype, mesh)

    rows = b * t * n * (1 if mesh is None else mesh.dp)
    with torch.no_grad():
        for norm, mean, var in zip(pointnet.norm, means, variances):
            m = norm.momentum
            unbiased = var * (rows / max(rows - 1, 1))
            norm.mean.copy_((1.0 - m) * norm.mean + m * mean)
            norm.var.copy_((1.0 - m) * norm.var + m * unbiased)

    # (B, T, filters[-1]) in f32; the encoder is in train mode
    h = encoder.backbone.tcn(pooled, compute_dtype=torch.float32)
    return encoder.heads(h.float().mean(dim=1))
