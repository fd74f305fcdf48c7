"""Training losses: cross-entropy, the conditional-Gaussian KL and the
triplet loss over Multi-Similarity-mined pairs.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/losses.py:12-108``, plain
PyTorch over fixed shapes. The model applies ELU to its logits before the
CE loss (a kept quirk of the reference model); the loss itself is the
standard mean log-softmax CE. The miner returns boolean masks over the
``(B, B)`` pair grid, and the triplet loss takes every (anchor, kept
positive, kept negative) triplet of the grid, as the JAX package does.

With a ``mesh`` (``parallel/mesh.py``) the batch's rows lie on the ranks of
its data group: the triplet loss then mines and sums over the global
``(B, B)`` grid of the all-gathered embeddings and labels, the loss of the
global batch on every data rank. The means need no mesh: a rank's mean
over its rows is its estimate of the global one, and the trainers take
each rank's share of the whole loss at once
(``train/pcaa.py::mesh_grads``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import Mesh


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``(B, K)`` logits against ``(B,)`` labels."""
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    return torch.mean(nll)


def cg_kl_divergence(mu: torch.Tensor, logvar: torch.Tensor, mu_k: torch.Tensor) -> torch.Tensor:
    """KL( N(mu, e^logvar) || N(mu_k, I) ), summed over the latent
    dimensions and averaged over the batch (reference ``CG_kl_divergence``,
    ``utils.py:72-85``)."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - (mu - mu_k) ** 2 - torch.exp(logvar), dim=1)
    return torch.mean(per_sample)


def multi_similarity_mine(embeddings: torch.Tensor, labels: torch.Tensor,
                          epsilon: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-Similarity pair mining (Wang et al., CVPR 2019) on the cosine
    similarities ``z @ z.T`` of normalized embeddings → ``(keep_pos,
    keep_neg)`` masks ``(B, B)``:

    - a positive pair (i, j), y_i == y_j and i != j, is kept iff
      ``sim_ij < max_k{sim_ik : y_k != y_i} + epsilon``;
    - a negative pair (i, k), y_i != y_k, is kept iff
      ``sim_ik > min_j{sim_ij : y_j == y_i, j != i} - epsilon``.

    An anchor with no negative (or no positive) takes a -inf (+inf)
    sentinel, against which every comparison is False.
    """
    sim = embeddings @ embeddings.T
    n = embeddings.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)
    same = labels[:, None] == labels[None, :]
    pos_mask = same & ~eye
    neg_mask = ~same
    inf = torch.tensor(float("inf"), dtype=sim.dtype, device=sim.device)
    hardest_neg = torch.amax(torch.where(neg_mask, sim, -inf), dim=1)
    easiest_pos = torch.amin(torch.where(pos_mask, sim, inf), dim=1)
    keep_pos = pos_mask & (sim < (hardest_neg[:, None] + epsilon))
    keep_neg = neg_mask & (sim > (easiest_pos[:, None] - epsilon))
    return keep_pos, keep_neg


def triplet_loss_with_ms_miner(embeddings: torch.Tensor, labels: torch.Tensor,
                               margin: float = 0.5, epsilon: float = 0.1,
                               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Triplet-margin loss over the Multi-Similarity-mined pairs: the mean
    of ``relu(d(a, p) - d(a, n) + margin)`` over the *violating* triplets
    (pytorch_metric_learning's ``AvgNonZeroReducer``), 0 when there are
    none, with ``d = sqrt(max(|a|² + |b|² - 2a·b, 0) + 1e-16)``. Expects
    L2-normalized embeddings (reference ``train_ORCED.py:30-34,161-163``).
    With a ``mesh``, the loss of the global batch (the module docstring)."""
    if mesh is not None and mesh.dp > 1:
        return triplet_loss_with_ms_miner(mesh.gather_data(embeddings), mesh.gather_data(labels),
                                          margin, epsilon)
    keep_pos, keep_neg = multi_similarity_mine(embeddings.detach(), labels, epsilon)
    sq_norm = torch.sum(embeddings ** 2, dim=1)
    sq = sq_norm[:, None] + sq_norm[None, :] - 2.0 * embeddings @ embeddings.T
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    dist = torch.sqrt(torch.maximum(sq, torch.zeros_like(sq)) + 1e-16)
    valid = keep_pos[:, :, None] & keep_neg[:, None, :]
    viol = F.relu(dist[:, :, None] - dist[:, None, :] + margin)
    viol = torch.where(valid, viol, torch.zeros_like(viol))
    n_nonzero = torch.sum(viol > 0)
    return torch.where(n_nonzero > 0, torch.sum(viol) / torch.clamp(n_nonzero, min=1),
                       torch.zeros_like(viol[0, 0, 0]))
