"""OR-CED baseline grid, sequential: openness levels × class subsets.

Port of the sequential mode of ``scripts/run_orced.py`` (``main``,
``:159-260``): for each number of training classes, draw ``--n-tests``
unique class subsets (numpy seed 0, ``run_pcaa_ablation.
unique_class_subsets``), write that subset's splits (seed 0) and train one
OR-CED run on them with the loss weights all 1 and triplet margin 0.5; run
names ``<base>.<n_tr>.<i>``, ``SEED`` = the subset's index, ``Openness``
from the class counts. A run whose folder holds ``run_complete.json`` is
skipped before its splits are written.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.run_orced \\
        --data-path RAW_TRACKS [--n-training-classes 2 4 6 8] [--device cuda]

The flags are the JAX driver's, plus ``--device`` (default ``cuda``).
``--compute-dtype bfloat16`` and ``--bf16-adam-nu`` train as the JAX
driver's do (bf16 compute, bf16 Adam moments); ``--grid`` and
``--bf16-weight-cache`` are not ported and raise ``NotImplementedError``.
OR-CED trains through plain PyTorch, as the JAX trainer reaches no kernel.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import N_SUBJECTS, default_config
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation import (
    apply_precision_flags,
    check_ported,
    unique_class_subsets,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import run_completed


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-path", required=True, help="raw tracks root")
    p.add_argument("--gen-data-path", default="data/generated_dataset")
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name-base", default="ORCED_")
    p.add_argument("--n-training-classes", type=int, nargs="+", default=[2, 4, 6, 8])
    p.add_argument("--n-tests", type=int, default=5)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--wandb-mode", default="disabled")
    p.add_argument("--no-skip-completed", action="store_true",
                   help="retrain runs whose folder already has a completion marker")
    p.add_argument("--grid", action="store_true",
                   help="train all splits of an openness level in lockstep (not ported)")
    p.add_argument("--grid-runs-per-device", type=int, default=2,
                   help="lockstep runs per device in --grid mode (not ported)")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="override Config.COMPUTE_DTYPE")
    p.add_argument("--bf16-adam-nu", action="store_true",
                   help="store Adam second moments in bf16")
    p.add_argument("--bf16-weight-cache", action="store_true",
                   help="bf16 copies of the decoder kernels (not ported)")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    check_ported(args)
    base_cfg = default_config(
        DATA_PATH=args.data_path,
        GEN_DATA_PATH=args.gen_data_path,
        MODELS_PATH=args.models_path,
        TRIPLET_W=1.0,
        CE_W=1.0,
        REC_W=1.0,
        KL_W=1.0,
        TRIPLET_MARGIN=0.5,
    )
    if args.epochs:
        base_cfg = base_cfg.replace(EPOCHS=args.epochs)
    base_cfg = apply_precision_flags(base_cfg, args)

    rng = np.random.default_rng(0)
    for n_tr in args.n_training_classes:
        for i, train_classes in enumerate(unique_class_subsets(n_tr, args.n_tests, rng)):
            name = f"{args.model_name_base}.{n_tr}.{i + 1}"
            # SEED=i: distinct init, shuffle and noise streams per run
            cfg = base_cfg.replace(
                MODEL_NAME=name,
                TRAIN_CLASSES=tuple(train_classes),
                Openness=openness(n_tr, N_SUBJECTS),
                SEED=i,
                NOTES="ORCED grid run",
            )
            if not args.no_skip_completed and run_completed(cfg.run_dir()):
                print(f"=== skipping completed {name} ===")
                continue
            generate_splits(
                data_path=cfg.DATA_PATH,
                gen_data_path=cfg.GEN_DATA_PATH,
                train_classes=train_classes,
                seed=0,
                nmax_points=cfg.NMAX,
                nsteps=cfg.NSTEPS,
                crop_step=cfg.CROP_STEP,
            )
            print(f"=== training {name} ===")
            out = train_orced(cfg, wandb_mode=args.wandb_mode, device=args.device)
            print(
                f"{name}: best_valid_acc={out['best_valid_accuracy']:.4f} "
                f"windows/s={out['windows_per_sec']:.1f}"
            )


if __name__ == "__main__":
    main()
