"""Pack trained run folders into serving artifacts (``.osgr``).

Port of ``scripts/export_serving.py`` (``:28-62``): each run is calibrated
and exported by ``infer/serving.py`` into one file that
``load_serving_artifact`` reads, on the CPU or the card. A name that
starts with ``ORCED`` (any case) exports one OR-CED artifact; any other
name one PCAA artifact per k of ``--ks``.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.export_serving \\
        --data-path RAW_TRACKS --model-names PCAA_Abl2_V4.8.1 ORCED_.8.1 --ks 6

The flags are the JAX driver's, plus ``--device`` (default ``cuda``), the
device that calibrates and traces.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import (
    export_orced_decision,
    export_pcaa_decision,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-names", nargs="+", required=True)
    p.add_argument("--models-path", default="models")
    p.add_argument("--data-path", default=None,
                   help="raw tracks root (for split regeneration during calibration)")
    p.add_argument("--ks", type=int, nargs="+", default=[6],
                   help="PCAA voting-window sizes (one artifact each)")
    p.add_argument("--no-generate-dataset", action="store_true",
                   help="calibrate against already-generated splits")
    p.add_argument("--device", default="cuda", help="torch device to calibrate and trace on")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    common = dict(models_path=args.models_path, data_path=args.data_path,
                  generate_dataset=not args.no_generate_dataset, device=args.device)
    for name in args.model_names:
        if name.upper().startswith("ORCED"):
            t0 = time.perf_counter()
            path, meta = export_orced_decision(name, **common)
            print(f"{name}: {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
                  f"{time.perf_counter() - t0:.2f} s) inputs={meta['inputs']}")
        else:
            for k in args.ks:
                t0 = time.perf_counter()
                path, meta = export_pcaa_decision(name, k, **common)
                print(f"{name} k={k}: {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
                      f"{time.perf_counter() - t0:.2f} s) "
                      f"threshold={meta['log_threshold']:.3f}")


if __name__ == "__main__":
    main()
