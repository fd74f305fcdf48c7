"""Point-subsampling sweep: PCAA V4 at NMAX ∈ {50..150}, trained and scored.

Port of ``scripts/run_pointsubsampling.py`` (``:30-117``): for each
number of training classes, class subset (``run_pcaa_ablation.
unique_class_subsets``, numpy seed 0) and point count, write the subset's
splits at that NMAX (seed 0), train V4 on them and score the run with
``pcaa_inference`` at ``--ks`` (``generate_dataset=False``: the splits
were just written); run names ``<base><n_points>.<n_tr>.<i>``, ``SEED`` =
the subset's index. A run that is trained (``run_complete.json``) and
scored (``naive_seq_log_<k>.json`` for every k) is skipped before its
splits are written; one that is trained but not scored gets its splits
written again and is scored without training.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pointsubsampling \\
        --data-path RAW_TRACKS [--n-points-subs 50 70 90 110 130 150] [--device cuda]

The flags are the JAX driver's, plus ``--device`` (default ``cuda``). The
CUDA training kernels are switched by the base configuration's
``FUSED_POINTNET``/``FUSED_ADAM``, whose defaults are off as in the JAX
package: a caller replaces this module's ``default_config`` to turn them
on.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import N_SUBJECTS, VARIATION, default_config
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation import unique_class_subsets
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import train_pcaa
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import run_completed


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-path", required=True, help="raw tracks root")
    p.add_argument("--gen-data-path", default="data/generated_dataset")
    p.add_argument("--models-path", default="models")
    p.add_argument("--figures-path", default="figures")
    p.add_argument("--model-name-base", default="PCAA_npts_V4_")
    p.add_argument("--n-training-classes", type=int, nargs="+", default=[2, 4, 6, 8])
    p.add_argument("--n-points-subs", type=int, nargs="+", default=[50, 70, 90, 110, 130, 150])
    p.add_argument("--n-tests", type=int, default=5)
    p.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4, 6])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--no-skip-completed", action="store_true",
                   help="retrain and rescore runs that are already done")
    p.add_argument("--device", default="cuda", help="torch device to train and score on")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    base_cfg = default_config(
        DATA_PATH=args.data_path,
        GEN_DATA_PATH=args.gen_data_path,
        MODELS_PATH=args.models_path,
        FIGURES_PATH=args.figures_path,
    )
    if args.epochs:
        base_cfg = base_cfg.replace(EPOCHS=args.epochs)

    rng = np.random.default_rng(0)
    for n_tr in args.n_training_classes:
        for i, train_classes in enumerate(unique_class_subsets(n_tr, args.n_tests, rng)):
            for n_points in args.n_points_subs:
                # SEED=i: the subsets of an openness level get distinct init,
                # shuffle and noise streams, as in the other drivers
                cfg = base_cfg.replace(
                    NMAX=n_points,
                    TRAIN_CLASSES=tuple(train_classes),
                    Openness=openness(n_tr, N_SUBJECTS),
                    MODEL_NAME=f"{args.model_name_base}{n_points}.{n_tr}.{i + 1}",
                    SEED=i,
                    NOTES=f"Runs with different number of points ({n_points}.{n_tr}.{i + 1})",
                )
                trained = not args.no_skip_completed and run_completed(cfg.run_dir())
                inferred = trained and all(
                    os.path.exists(os.path.join(cfg.run_dir(), f"naive_seq_log_{k}.json"))
                    for k in args.ks
                )
                if inferred:
                    print(f"=== skipping completed {cfg.MODEL_NAME} ===")
                    continue
                generate_splits(
                    data_path=cfg.DATA_PATH,
                    gen_data_path=cfg.GEN_DATA_PATH,
                    train_classes=train_classes,
                    seed=0,
                    nmax_points=n_points,
                    nsteps=cfg.NSTEPS,
                    crop_step=cfg.CROP_STEP,
                )
                if not trained:
                    print(f"=== training {cfg.MODEL_NAME} ===")
                    train_pcaa(cfg, VARIATION.V4, wandb_mode="disabled", device=args.device)
                else:
                    print(f"=== re-running inference for {cfg.MODEL_NAME} ===")
                pcaa_inference(
                    [cfg.MODEL_NAME],
                    ks=args.ks,
                    models_path=args.models_path,
                    figures_path=args.figures_path,
                    data_path=args.data_path,
                    variation=VARIATION.V4,
                    generate_dataset=False,  # written above at this NMAX
                    device=args.device,
                )


if __name__ == "__main__":
    main()
