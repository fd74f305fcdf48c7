"""Per-epoch training metrics: ``metrics.jsonl`` in the run folder.

Port of ``opensetgaitrecognition_pcaa_tpu/train/metrics.py``: one JSON
object per epoch, ``_step`` (the epoch), ``_wall`` (seconds since the
logger opened) and the reference's metric names. wandb is not ported (the
card's machine has none): a ``mode`` other than ``"disabled"`` raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_dir: str, mode: str = "disabled"):
        if mode != "disabled":
            raise NotImplementedError(
                f"wandb mode {mode!r}: the port writes metrics.jsonl only"
            )
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"_step": step, "_wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def finish(self) -> None:
        self._file.close()
