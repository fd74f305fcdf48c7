"""OR-CED baseline grid: openness levels × class subsets, one run after
another or (``--grid``) as grids of runs on the cards.

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

``--grid`` is the port of the JAX driver's grid mode (``run_grid_mode``
and ``_run_orced_chunk``, ``:29-156``): the splits of each openness level
train as grids (``parallel/grid.py::GridORCEDTrainer``) of
``--grid-runs-per-device`` runs per device, spread over the cards as
``run_pcaa_ablation --grid`` does, into the per-split directories
``<gen>_orcedgrid<n_tr>_<i>``, with
``NOTES`` "Grid-parallel ORCED run", four metrics logged per epoch, the
best weights by validation accuracy every ``CHECKPOINT_FREQUENCY`` epochs
and a ``run_complete.json`` that holds only ``best_valid_accuracy``.
Completed splits are skipped before any split is written. As there,
spreading a chunk over the cards buys memory, not speed.

The flags are the JAX driver's, plus ``--device`` (default ``cuda``).
``--compute-dtype bfloat16``, ``--bf16-adam-nu`` and
``--bf16-weight-cache`` train as the JAX driver's do (bf16 compute, bf16
Adam moments, bf16 copies of the decoder's weights), in both modes; the
last needs the first, or the build refuses the run, as in JAX.
OR-CED trains through plain PyTorch, as the JAX trainer reaches no kernel.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import N_SUBJECTS, SPLIT, default_config
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridORCEDTrainer, mesh_chunks
from opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation import (
    apply_precision_flags,
    grid_devices,
    open_run_folders,
    unique_class_subsets,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced, write_orced_checkpoint
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import mark_run_completed, run_completed


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
                   help="train all splits of an openness level as grids over the cards "
                   "(parallel/grid.py) instead of one after another")
    p.add_argument("--grid-runs-per-device", type=int, default=2,
                   help="runs per grid chunk in --grid mode; splits beyond it train "
                   "in sequential chunks")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="override Config.COMPUTE_DTYPE")
    p.add_argument("--bf16-adam-nu", action="store_true",
                   help="store Adam second moments in bf16")
    p.add_argument("--bf16-weight-cache", action="store_true",
                   help="bf16 copies of the decoder kernels, refreshed after the Adam step; "
                   "the same bits as without it; requires --compute-dtype bfloat16")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    return p


def run_grid_mode(args: argparse.Namespace, base_cfg) -> None:
    """``--grid``: per openness level, skip the completed splits before any
    split is written, write and load the others, then train them in
    grid chunks of ``--grid-runs-per-device`` runs."""
    rng = np.random.default_rng(0)
    devices = grid_devices(args.device)
    for n_tr in args.n_training_classes:
        subsets = unique_class_subsets(n_tr, args.n_tests, rng)
        gen_dirs = [f"{args.gen_data_path}_orcedgrid{n_tr}_{i}" for i in range(args.n_tests)]
        all_cfgs = [
            base_cfg.replace(
                MODEL_NAME=f"{args.model_name_base}.{n_tr}.{i + 1}",
                TRAIN_CLASSES=tuple(subsets[i]),
                Openness=openness(n_tr, N_SUBJECTS),
                GEN_DATA_PATH=gen_dirs[i],
                SEED=i,
                NOTES="Grid-parallel ORCED run",
            )
            for i in range(args.n_tests)
        ]
        todo = [i for i in range(args.n_tests)
                if args.no_skip_completed or not run_completed(all_cfgs[i].run_dir())]
        if len(todo) < args.n_tests:
            done = sorted(set(range(args.n_tests)) - set(todo))
            print(f"    skipping completed splits {[i + 1 for i in done]}")

        data = {}
        for i in todo:
            generate_splits(data_path=args.data_path, gen_data_path=gen_dirs[i],
                            train_classes=subsets[i], seed=0, nmax_points=base_cfg.NMAX,
                            nsteps=base_cfg.NSTEPS, crop_step=base_cfg.CROP_STEP, verbose=False)
            data[i] = tuple(RadarCropDataset(split, gen_dirs[i]).load_all()
                            for split in (SPLIT.TRAIN, SPLIT.VALID))
        cap = args.grid_runs_per_device * len(devices)
        for chunk, use_mesh in mesh_chunks(todo, cap, len(devices)):
            print(f"=== grid-training ORCED n_tr={n_tr} (splits {[i + 1 for i in chunk]} "
                  f"lockstep{'' if use_mesh else ', unsharded'}) ===")
            # one call per chunk: its trainer is freed before the next is built
            _run_orced_chunk(base_cfg, [all_cfgs[i] for i in chunk], [data[i] for i in chunk],
                             args.device, devices if use_mesh else None)
        del data


def _run_orced_chunk(base_cfg, cfgs, chunk_data, device, mesh=None) -> None:
    """Train one chunk of splits through the grid trainer (its runs spread
    over the devices of ``mesh``, else on ``device``) and write each run's
    folder: ``config.json``, ``metrics.jsonl``, the best E, G and ML
    files by validation accuracy (checked every ``CHECKPOINT_FREQUENCY``
    epochs) and ``run_complete.json``."""
    trainer = GridORCEDTrainer(cfgs, train_sets=[d[0] for d in chunk_data],
                               valid_sets=[d[1] for d in chunk_data], mesh=mesh, device=device)
    loggers = open_run_folders(cfgs)

    for epoch in range(base_cfg.EPOCHS):
        m = trainer.run_epoch(epoch)
        if epoch % base_cfg.CHECKPOINT_FREQUENCY == 0:
            trainer.note_validation(trainer.valid_accuracy(epoch))
        for r, logger in enumerate(loggers):
            logger.log({
                "Total Loss Train": float(m["tot_loss"][r]),
                "KL Loss": float(m["kl_loss"][r]),
                "Triplet Loss": float(m["trip_loss"][r]),
                "Train Accuracy": float(m["train_accuracy"][r]),
            }, step=epoch)

    for r, (cfg, payload, logger) in enumerate(zip(cfgs, trainer.best_run_payloads(), loggers)):
        write_orced_checkpoint(cfg.run_dir(), cfg.MODEL_NAME, payload)
        logger.finish()
        mark_run_completed(cfg.run_dir(), {"best_valid_accuracy": float(trainer._best_accs[r])})
    print(f"    best valid accs: {np.round(trainer._best_accs, 4)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
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
    if args.grid:
        run_grid_mode(args, base_cfg)
        return

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
