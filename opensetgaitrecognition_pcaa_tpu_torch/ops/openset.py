"""Open-set scoring: mixture log-likelihoods, the Youden-J threshold, and
OR-CED's latent score.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/openset.py:17-151``, numpy
and scipy in f64. The reference scores a latent by the mean of
unit-covariance Gaussian pdfs, values around 1e-40; here that score is kept
in log space, which preserves every comparison the decisions make, and
``underflow_tied`` restores the ties that the reference's linear-space pdf
has where it underflows to 0.0.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf, logsumexp


def openness(n_train: int, n_test: int) -> float:
    """Openness ``1 - sqrt(2 n_tr / (n_tr + n_te))``."""
    return float(1.0 - np.sqrt((2.0 * n_train) / (n_train + n_test)))


def log_joint_likelihood(x: np.ndarray, means: np.ndarray) -> np.ndarray:
    """``log((1/K) Σ_k N(x; m_k, I))`` for ``x`` ``(n, d)`` or ``(d,)`` and
    ``means`` ``(K, d)`` → ``(n,)`` (a scalar for a single vector)."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    means = np.asarray(means, dtype=np.float64)
    d = means.shape[1]
    sq = (
        (x * x).sum(axis=1)[:, None]
        + (means * means).sum(axis=1)[None, :]
        - 2.0 * x @ means.T
    )
    log_pdf = -0.5 * sq - 0.5 * d * np.log(2.0 * np.pi)
    out = logsumexp(log_pdf, axis=1) - np.log(means.shape[0])
    return out if out.shape[0] > 1 else out[0]


def underflow_tied(log_scores: np.ndarray) -> np.ndarray:
    """Map every log-score whose ``exp`` underflows f64 to ``-inf``.

    The reference's linear-space scores are exactly 0.0 there, all tied in
    its ROC and below any positive threshold; pure log-space scores would
    break those ties and could accept a crop the reference rejects. This
    makes the log scores order-isomorphic to the reference's, ties
    included. Keep it exactly so.
    """
    ls = np.asarray(log_scores, dtype=np.float64)
    with np.errstate(under="ignore"):
        return np.where(np.exp(ls) == 0.0, -np.inf, ls)


def roc_points(y_true: np.ndarray, scores: np.ndarray):
    """ROC points ``(fpr, tpr, thresholds)`` in sklearn's order: distinct
    scores decreasing, led by the ``(0, 0, +inf)`` point; a point counts
    ``score >= threshold`` as positive. Collinear points are kept (sklearn
    drops them), which cannot move the Youden-J argmax."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    y_sorted = y_true[order]
    s_sorted = scores[order]
    # != rather than np.diff, so that ±inf ties are found
    distinct = np.where(s_sorted[1:] != s_sorted[:-1])[0]
    idx = np.r_[distinct, len(s_sorted) - 1]
    tps = np.cumsum(y_sorted)[idx]
    fps = (1 + idx) - tps
    tpr = tps / max(int(y_true.sum()), 1)
    fpr = fps / max(int((~y_true).sum()), 1)
    return (
        np.r_[0.0, fpr],
        np.r_[0.0, tpr],
        np.r_[np.inf, s_sorted[idx]],
    )


def best_youden_threshold(y_true: np.ndarray, scores: np.ndarray) -> float:
    """The threshold that maximizes J = tpr − fpr; ties take the first
    (highest) threshold, and +inf when no finite one has J > 0."""
    fpr, tpr, thresholds = roc_points(y_true, scores)
    return float(thresholds[int(np.argmax(tpr - fpr))])


def hyperrectangle_prob(mean: np.ndarray, cov_diag: np.ndarray, z: np.ndarray) -> np.ndarray:
    """``mvn.cdf(b) − mvn.cdf(a)`` with ``a, b = mean ∓ |z − mean|`` for
    ``X ~ N(mean, diag(cov_diag))``, in closed form:
    ``prod_i Φ(h_i) − prod_i (1 − Φ(h_i))`` with ``h = |z − mean| / sqrt(cov_diag)``.

    This is the reference's difference of two cdfs, not the box's
    probability. Its callers pass standard deviations as ``cov_diag``
    (``diag(std)``, not ``diag(std²)``), as the reference does; keep it so.
    ``mean``, ``cov_diag`` ``(d,)``, ``z`` ``(n, d)`` → ``(n,)``.
    """
    mean = np.asarray(mean, dtype=np.float64)
    cov_diag = np.asarray(cov_diag, dtype=np.float64)
    z = np.atleast_2d(np.asarray(z, dtype=np.float64))
    h = np.abs(z - mean[None, :]) / np.sqrt(cov_diag)[None, :]
    phi_upper = 0.5 * (1.0 + erf(h / np.sqrt(2.0)))  # Φ(h)
    return np.prod(phi_upper, axis=1) - np.prod(1.0 - phi_upper, axis=1)


def normal_pdf(x: np.ndarray, loc: float, scale: float) -> np.ndarray:
    """1-D normal pdf."""
    x = np.asarray(x, dtype=np.float64)
    return np.exp(-0.5 * ((x - loc) / scale) ** 2) / (scale * np.sqrt(2 * np.pi))
