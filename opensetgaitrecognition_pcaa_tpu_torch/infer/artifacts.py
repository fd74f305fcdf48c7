"""Evaluation artifacts: metrics JSON, the open-set F1 scores and the
confusion-matrix PNG.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/artifacts.py:28-88``. F1
is written in numpy to sklearn's definition, so the port needs no sklearn:
the labels are the sorted union of ``y_true`` and ``y_pred``; per label
``F1 = 2·tp / (true + pred)``, 0 where that denominator is 0; micro pools
the counts over labels, macro averages the per-label scores, weighted
averages them by each label's count in ``y_true``.

The confusion matrix is the JAX package's: ``labels=range(n + 1)`` (the
seen classes and "unseen"), rows normalized by their true counts, a row
with no samples written as 0. The PNG is written with numpy and zlib, as
the port has no matplotlib: a heatmap of that matrix, one square of
``_CELL`` pixels a cell, through a fixed colour ramp on [0, 1]
(``colour_ramp``, white to navy in 256 steps, red = 255 − step), 8-bit
RGB. It carries no tick text; a cell's value is its colour's step in the
ramp, within one step of 1/255.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict

_CELL = 32  # pixels a side of one matrix cell
_RAMP_ENDS = ((255, 255, 255), (0, 32, 96))  # the colours of 0 and 1: white, navy

import numpy as np


def save_json(obj: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _f1(tp: np.ndarray, true: np.ndarray, pred: np.ndarray) -> np.ndarray:
    denom = true.astype(np.float64) + pred.astype(np.float64)
    safe = np.where(denom == 0, 1.0, denom)
    return np.where(denom == 0, 0.0, 2.0 * tp.astype(np.float64) / safe)


def openset_metrics(final_labels: np.ndarray, final_preds: np.ndarray) -> Dict:
    """accuracy + micro/macro/weighted F1 (reference ``inference_PCAA.py:325-331``)."""
    y_true = np.asarray(final_labels).astype(int)
    y_pred = np.asarray(final_preds).astype(int)
    labels = np.union1d(y_true, y_pred)
    true = (y_true[:, None] == labels[None, :]).sum(axis=0)
    pred = (y_pred[:, None] == labels[None, :]).sum(axis=0)
    tp = ((y_true == y_pred)[:, None] & (y_true[:, None] == labels[None, :])).sum(axis=0)
    per_label = _f1(tp, true, pred)
    micro = _f1(tp.sum(keepdims=True), true.sum(keepdims=True), pred.sum(keepdims=True))
    weighted = (
        np.average(per_label, weights=true) if true.sum() > 0 else per_label.mean()
    )
    return {
        "accuracy": float(np.equal(y_true, y_pred).sum() / len(y_true)),
        "f1_micro": float(micro[0]),
        "f1_macro": float(per_label.mean()),
        "f1_weighted": float(weighted),
    }


def openset_confusion_matrix(final_labels: np.ndarray, final_preds: np.ndarray,
                             n_labels: int) -> np.ndarray:
    """``(n_labels + 1)²`` f64 confusion matrix, rows normalized by their
    true counts, a row with no samples 0 (sklearn's ``confusion_matrix(...,
    normalize="true", labels=range(n_labels + 1))``; samples outside those
    labels are left out)."""
    y_true = np.asarray(final_labels).astype(int)
    y_pred = np.asarray(final_preds).astype(int)
    k = n_labels + 1
    ok = (y_true >= 0) & (y_true < k) & (y_pred >= 0) & (y_pred < k)
    counts = np.zeros((k, k), np.int64)
    np.add.at(counts, (y_true[ok], y_pred[ok]), 1)
    totals = counts.sum(axis=1, keepdims=True)
    return np.where(totals > 0, counts / np.maximum(totals, 1), 0.0)


def colour_ramp() -> np.ndarray:
    """``(256, 3)`` uint8: the colour of each step of [0, 1], linear
    between ``_RAMP_ENDS``; the red channel is 255 − step, so no two steps
    share a colour."""
    lo, hi = (np.asarray(c, np.float64) for c in _RAMP_ENDS)
    t = np.arange(256)[:, None] / 255.0
    return np.rint(lo + t * (hi - lo)).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(rgb: np.ndarray, path: str) -> None:
    """An 8-bit RGB PNG of ``rgb`` ``(H, W, 3)`` uint8: IHDR, one zlib IDAT
    of unfiltered rows, IEND."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def plot_openset_confusion_matrix(final_labels: np.ndarray, final_preds: np.ndarray,
                                  n_labels: int, out_path: str) -> None:
    """The normalized open-set confusion matrix as a heatmap PNG at
    ``out_path`` (reference ``plot_confusion_matrix_cgaae``,
    ``inference_PCAA.py:350-379``): row i is true class i, column j the
    decision j, the last row and column "unseen"."""
    cm = openset_confusion_matrix(final_labels, final_preds, n_labels)
    steps = np.rint(np.clip(cm, 0.0, 1.0) * 255).astype(np.intp)
    cells = np.repeat(np.repeat(steps, _CELL, axis=0), _CELL, axis=1)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_png(colour_ramp()[cells], out_path)
