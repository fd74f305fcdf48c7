"""The port's confusion-matrix artifact and metrics logger.

The matrix is held against sklearn's ``confusion_matrix(normalize="true",
labels=range(n + 1))`` with NaN rows written as 0, as the JAX package
computes it. The PNG is checked byte by byte as a file (signature, chunk
CRCs, IHDR size) and decoded by an independent reader (matplotlib's,
through Pillow): each cell's colour maps back to the matrix within one
step of the ramp, 1/255.
"""

import json
import struct
import sys
import warnings
import zlib

import matplotlib.image as mpimg
import numpy as np
import pytest
from sklearn.metrics import confusion_matrix

from opensetgaitrecognition_pcaa_tpu_torch.infer import artifacts
from opensetgaitrecognition_pcaa_tpu_torch.train.metrics import MetricLogger


def _decisions(seed, n_labels, size, absent=None):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels + 1, size)
    preds = np.where(rng.random(size) < 0.6, labels, rng.integers(0, n_labels + 1, size))
    if absent is not None:  # a class with no samples: a NaN row in sklearn
        keep = labels != absent
        labels, preds = labels[keep], preds[keep]
    return labels, preds


CASES = {"six_classes": (0, 6, 300, None), "absent_class": (1, 3, 120, 2),
         "two_classes": (2, 2, 9, None)}


@pytest.mark.parametrize("name", list(CASES))
def test_matrix_equals_sklearn(name):
    seed, n_labels, size, absent = CASES[name]
    labels, preds = _decisions(seed, n_labels, size, absent)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.nan_to_num(confusion_matrix(labels, preds, normalize="true",
                                              labels=list(range(n_labels + 1))))
    got = artifacts.openset_confusion_matrix(labels, preds, n_labels)
    assert got.shape == (n_labels + 1, n_labels + 1)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    if absent is not None:
        assert not got[absent].any()


def _chunks(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        out.append((tag, body))
        pos += 12 + length
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_png_is_valid_and_decodes_to_the_matrix(name, tmp_path):
    seed, n_labels, size, absent = CASES[name]
    labels, preds = _decisions(seed, n_labels, size, absent)
    path = str(tmp_path / "figs" / "cm.png")
    artifacts.plot_openset_confusion_matrix(labels, preds, n_labels, path)
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    assert [tag for tag, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    side = artifacts._CELL * (n_labels + 1)
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (side, side, 8, 2, 0, 0, 0)
    assert len(zlib.decompress(chunks[1][1])) == side * (3 * side + 1)

    image = np.rint(mpimg.imread(path) * 255).astype(np.int64)
    assert image.shape == (side, side, 3)
    ramp = artifacts.colour_ramp().astype(np.int64)
    cm = artifacts.openset_confusion_matrix(labels, preds, n_labels)
    half = artifacts._CELL // 2
    for i in range(n_labels + 1):
        for j in range(n_labels + 1):
            block = image[i * artifacts._CELL:(i + 1) * artifacts._CELL,
                          j * artifacts._CELL:(j + 1) * artifacts._CELL]
            assert (block == block[half, half]).all()  # one colour a cell
            step = int(np.argmin(np.abs(ramp - block[half, half]).sum(1)))
            assert (ramp[step] == block[half, half]).all()
            assert abs(step / 255 - cm[i, j]) <= 1 / 255, (i, j, step, cm[i, j])


def test_metric_logger_falls_back_to_jsonl_without_wandb(tmp_path, monkeypatch):
    """A wandb mode where wandb cannot be imported (as on the card's
    machine) writes metrics.jsonl alone, as the JAX package's logger does."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    logger = MetricLogger(str(tmp_path), {"MODEL_NAME": "X"}, mode="offline")
    logger.log({"Train Accuracy": 0.5}, step=0)
    logger.log({"Train Accuracy": 0.75}, step=1)
    logger.finish()
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [(r["_step"], r["Train Accuracy"]) for r in lines] == [(0, 0.5), (1, 0.75)]
