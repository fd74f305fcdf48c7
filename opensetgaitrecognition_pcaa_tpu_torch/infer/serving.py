"""In-process open-set decisions: PCAA on k-crop windows, OR-CED on crops.

Port of ``make_pcaa_decision_fn``, ``make_orced_forward_fn`` and
``orced_decide_host`` (``opensetgaitrecognition_pcaa_tpu/infer/
serving.py:85-186``).

- PCAA: a request is ``(B, k, T, N, C)`` windows of k sequential crops; the
  answer is one decision per window (a train-class index, or ``n_labels``
  for "unknown") and the count of crops above the threshold. The encoder
  runs folded (the CUDA PointNet kernel on the card); the mixture score
  runs in f64 on the same device, with the underflow tie of
  ``ops/openset.py::underflow_tied``.
- OR-CED: the device forward (folded encoder with a given eps, argmax,
  latent, decoder, per-crop Chamfer through the CUDA kernel) and the host
  f64 epilogue through ``infer/orced.py::orced_criteria``, so its
  decisions are those of ``orced_apply_ood``.

The exported ``.osgr`` artifact is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import (
    fused_encoder_apply,
    fused_orced_encoder_apply,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
    THRESHOLD_G,
    ORCEDClassStats,
    orced_criteria,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer_kernel import seq_chamfer_kernel

# ln(2**-1075): np.exp rounds to exactly 0.0 below this
_EXP_UNDERFLOW = -1075.0 * math.log(2.0)


def _log_joint_likelihood64(fv: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """f64 ``ops/openset.py::log_joint_likelihood`` with the underflow ties."""
    x = fv.double()
    sq = (
        (x * x).sum(dim=1)[:, None]
        + (means * means).sum(dim=1)[None, :]
        - 2.0 * x @ means.t()
    )
    d = means.shape[1]
    log_pdf = -0.5 * sq - 0.5 * d * math.log(2.0 * math.pi)
    ll = torch.logsumexp(log_pdf, dim=1) - math.log(means.shape[0])
    return torch.where(ll < _EXP_UNDERFLOW, torch.full_like(ll, -math.inf), ll)


def make_pcaa_decision_fn(encoder: CGEncoder, n_labels: int, k: int):
    """→ ``decide(means, log_threshold, windows)``.

    ``means``: ``(K, d)`` mixture centres, moved to the windows' device in
    f64; ``windows``: ``(B, k, T, N, C)`` f32 on the encoder's device.
    Returns ``(decisions (B,) int64, n_above (B,) int64)``, the decisions
    of ``infer/pcaa.py::_window_vote`` for single-label windows.
    """
    ieee_f32()

    @torch.inference_mode()
    def decide(means, log_threshold: float, windows: torch.Tensor):
        b = windows.shape[0]
        flat = windows.reshape((b * k,) + tuple(windows.shape[2:]))
        logits, fv = fused_encoder_apply(encoder, flat)
        preds = logits.argmax(dim=1).reshape(b, k)
        means64 = torch.as_tensor(np.asarray(means), dtype=torch.float64, device=fv.device)
        ll = _log_joint_likelihood64(fv, means64).reshape(b, k)
        n_above = (ll > log_threshold).sum(dim=1)
        majority = F.one_hot(preds, n_labels).sum(dim=1).argmax(dim=1)
        decisions = torch.where(n_above * 2 > k, majority, torch.full_like(majority, n_labels))
        return decisions, n_above

    return decide


def make_orced_forward_fn(encoder: ORCEDEncoder, decoder: ORCEDDecoder):
    """→ ``forward(x, eps)``, the device part of the OR-CED decision.

    ``x``: ``(B, T, N, C)`` f32 crops and ``eps``: ``(B, latent)`` f32
    reparametrization draws, both on the modules' device. Returns
    ``(preds (B,) int64, z (B, latent) f32, re (B,) f32)``: argmax class,
    latent sample and per-crop Chamfer reconstruction error.
    """
    ieee_f32()

    @torch.inference_mode()
    def forward(x: torch.Tensor, eps: torch.Tensor):
        logits, z, _, _ = fused_orced_encoder_apply(encoder, x, eps=eps)
        return logits.argmax(dim=1), z, seq_chamfer_kernel(decoder(z), x, avg_out=False)

    return forward


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def orced_decide_host(preds, z, re, means_z, stds_z, thr_re, n_labels: int,
                      threshold_g: float = THRESHOLD_G):
    """Host f64 epilogue over ``make_orced_forward_fn``'s outputs (tensors
    or arrays) → ``(decisions (B,) int64, latent_flag (B,) bool,
    rec_flag (B,) bool)``."""
    preds = _host(preds)
    stats = ORCEDClassStats(
        means_z=np.asarray(means_z, np.float64),
        stds_z=np.asarray(stds_z, np.float64),
        thresholds_re=np.asarray(thr_re, np.float64),
        n_classes=int(n_labels),
    )
    latent_flag, rec_flag = orced_criteria(
        stats, threshold_g, preds, _host(z).astype(np.float64), _host(re).astype(np.float64)
    )
    decisions = np.array(preds, dtype=np.int64)
    decisions[latent_flag | rec_flag] = int(n_labels)
    return decisions, latent_flag, rec_flag
