"""Sequence Chamfer distance, plain PyTorch.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/chamfer.py``, the version
the JAX package trains with (its Pallas Chamfer kernel serves only ORCED
inference; the port's CUDA counterpart is ``ops/chamfer_kernel.py``).
Bidirectional sum of min squared distances between two point-cloud
sequences, averaged over batch and time (or per sample over time). The
squared distances use the ``xx + yy − 2xy`` form, as the JAX package does,
so both cancel alike in f32. Layout ``(B, T, N, C)``.
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, ``(..., N, C) x (..., M, C) -> (..., N, M)``."""
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    xy = torch.matmul(x, y.transpose(-1, -2))
    return xx[..., :, None] + yy[..., None, :] - 2.0 * xy


def frame_chamfer(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Per-frame Chamfer sums ``(B, T)`` of ``preds`` ``(B, T, N, C)`` and
    ``gts`` ``(B, T, M, C)``."""
    p = pairwise_sq_dists(gts, preds)  # P[b, t, i, j] = |gts_i - preds_j|²
    loss_1 = torch.sum(torch.amin(p, dim=2), dim=2)  # each pred point's nearest gt
    loss_2 = torch.sum(torch.amin(p, dim=3), dim=2)  # each gt point's nearest pred
    return loss_1 + loss_2


def seq_chamfer(preds: torch.Tensor, gts: torch.Tensor, avg_out: bool = True) -> torch.Tensor:
    """Chamfer distance between ``preds`` ``(B, T, N, C)`` and ``gts``
    ``(B, T, M, C)``: a scalar mean over (batch, time) if ``avg_out``, else
    the ``(B,)`` per-sample means over time."""
    total = frame_chamfer(preds, gts)  # (B, T)
    if avg_out:
        return torch.mean(total)
    return torch.mean(total, dim=1)
