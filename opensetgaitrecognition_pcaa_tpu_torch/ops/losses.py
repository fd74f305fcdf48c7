"""Training losses: cross-entropy.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/losses.py:12-21``. The
model applies ELU to its logits before this loss (a kept quirk of the
reference model); the loss itself is the standard mean log-softmax CE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``(B, K)`` logits against ``(B,)`` labels."""
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    return torch.mean(nll)
