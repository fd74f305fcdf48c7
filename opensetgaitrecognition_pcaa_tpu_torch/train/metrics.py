"""Per-epoch training metrics: ``metrics.jsonl`` in the run folder, and
wandb where it is installed.

Port of ``opensetgaitrecognition_pcaa_tpu/train/metrics.py``: one JSON
object per epoch, ``_step`` (the epoch), ``_wall`` (seconds since the
logger opened) and the reference's metric names. A ``mode`` other than
``"disabled"`` also logs to wandb when the package can be imported; where
it cannot (the card's machine has none), the logger writes the JSONL file
alone, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_dir: str, config: Optional[dict] = None, mode: str = "disabled"):
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        self._wandb = None
        if mode != "disabled":
            try:
                import wandb  # type: ignore
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(
                    project="PCAA",
                    config=config,
                    name=(config or {}).get("MODEL_NAME"),
                    notes=(config or {}).get("NOTES"),
                    reinit=True,
                    mode=mode,
                )

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"_step": step, "_wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
