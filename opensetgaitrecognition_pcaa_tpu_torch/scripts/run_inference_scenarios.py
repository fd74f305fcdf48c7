"""Per-scenario open-set inference over trained PCAA runs.

Port of ``scripts/run_inference_scenarios.py`` (``:19-46``): one
``pcaa_inference`` per walking scenario, restricted to it, at ks 6 4 2 1,
over the given run names. The splits are written from the raw tracks on
the first pass only (they do not depend on the scenario, which filters at
load time), and not at all with ``--no-generate-dataset``. The files take
the names of ``infer/pcaa.py::_artifact_suffix``:
``naive_seq_log_<k>_scenarios<scenario>.json`` and the arrays beside it.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.run_inference_scenarios \\
        --data-path RAW_TRACKS --model-names NAME [NAME ...] [--device cuda]

The flags are the JAX driver's, plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-path", required=True, help="raw tracks root")
    p.add_argument("--models-path", default="models")
    p.add_argument("--figures-path", default="figures")
    p.add_argument("--model-names", nargs="+", required=True)
    p.add_argument("--ks", type=int, nargs="+", default=[6, 4, 2, 1])
    p.add_argument("--no-generate-dataset", action="store_true",
                   help="reuse the splits already written (write none)")
    p.add_argument("--device", default="cuda", help="torch device to score on")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    for i, scenario in enumerate(SCENARIO):
        print(f"=== scenario {scenario.value} ===")
        pcaa_inference(
            args.model_names,
            ks=args.ks,
            models_path=args.models_path,
            figures_path=args.figures_path,
            data_path=args.data_path,
            scenarios_list=[scenario],
            generate_dataset=not args.no_generate_dataset and i == 0,
            device=args.device,
        )


if __name__ == "__main__":
    main()
