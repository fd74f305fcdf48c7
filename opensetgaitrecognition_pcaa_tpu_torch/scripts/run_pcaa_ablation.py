"""PCAA ablation: openness levels × splits × variants, one run after
another or (``--grid``) as grids of runs on the cards.

Port of the sequential mode of ``scripts/run_pcaa_ablation.py`` (``main``,
``:226-337``, and ``unique_class_subsets``, ``:33-41``): for each number
of training classes, draw ``--n-tests`` unique class subsets (numpy seed
0), write that subset's splits (seed 0) and train each variant on them;
run names ``<base><variant>.<n_tr>.<i>``, ``SEED`` = the subset's index,
``Openness`` from the class counts. A run whose folder holds
``run_complete.json`` is skipped; the splits of a subset are written only
when one of its runs still has to train, as the JAX driver's ``--grid``
mode decides, so a finished sweep is skipped without touching the data.
An interrupted run resumes from its ``train_state.msgpack`` when the
configuration saves one (``SAVE_RESUME_STATE``).

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation \\
        --data-path RAW_TRACKS [--variants V1 V2 V3 V4] [--device cuda]

``--grid`` is the port of the JAX driver's grid mode (``run_grid_mode``
and ``run_grid_chunk``, ``:43-223``): the splits of each (variant,
openness) cell train as grids (``parallel/grid.py::GridPCAATrainer``) of
``--grid-runs-per-device`` runs per device, over every card with a CUDA
``--device`` (a chunk whose run count the cards divide spreads its runs
over them, ``mesh_chunks``; a ragged tail trains on ``--device``) and on
the one device otherwise, into the per-split directories
``<gen>_grid<n_tr>_<i>``; the runs are the sequential mode's (names,
``SEED``, class subsets), with ``NOTES`` "Grid-parallel ablation run,
Variant N", three metrics logged per epoch, validation on checkpoint
epochs, and a ``run_complete.json`` that holds only
``best_valid_accuracy``. Completed splits are skipped before
any split is written; the grid writes no resume state. Spreading a chunk
over the cards buys memory, not speed: one thread steps its runs in turn
(``parallel/grid.py``), so n cards hold n times the runs of one in about
the time one card takes for them.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.run_pcaa_ablation \\
        --data-path RAW_TRACKS --grid [--grid-runs-per-device 2] [--device cuda]

The flags are the JAX driver's, plus ``--device`` (default ``cuda``).
``--compute-dtype bfloat16``, ``--bf16-adam-nu`` and
``--bf16-weight-cache`` train as the JAX driver's do (bf16 compute, bf16
Adam moments, bf16 copies of the decoder's weights), in both modes; the
last needs the first, or the build refuses the run, as in JAX. The CUDA training kernels are switched by the base configuration's
``FUSED_POINTNET``/``FUSED_ADAM``, whose defaults are off as in the JAX
package: a caller replaces this module's ``default_config`` to turn them
on.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import (
    N_SUBJECTS,
    SPLIT,
    VARIATION,
    default_config,
)
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import openness
from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridPCAATrainer, mesh_chunks
from opensetgaitrecognition_pcaa_tpu_torch.train.metrics import MetricLogger
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS, _checkpoint, train_pcaa
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    mark_run_completed,
    run_completed,
    save_array,
)


def unique_class_subsets(n_tr: int, n_tests: int, rng: np.random.Generator) -> List[List[int]]:
    """``n_tests`` unique sorted random subsets of ``n_tr`` of the
    ``N_SUBJECTS`` classes (reference ``PCAA_ablation.py:1140-1150``)."""
    chosen: List[List[int]] = []
    while len(chosen) < n_tests:
        subset = sorted(rng.choice(N_SUBJECTS, n_tr, replace=False).tolist())
        if subset not in chosen:
            chosen.append(subset)
    return chosen


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-path", required=True, help="raw tracks root")
    p.add_argument("--gen-data-path", default="data/generated_dataset")
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name-base", default="PCAA_Abl2_")
    p.add_argument("--n-training-classes", type=int, nargs="+", default=[2, 4, 6, 8])
    p.add_argument("--n-tests", type=int, default=5)
    p.add_argument("--variants", nargs="+", default=["V1", "V2", "V3", "V4"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--wandb-mode", default="disabled")
    p.add_argument("--no-skip-completed", action="store_true",
                   help="retrain runs whose folder already has a completion marker")
    p.add_argument("--grid-runs-per-device", type=int, default=2,
                   help="runs per grid chunk in --grid mode; splits beyond it train "
                   "in sequential chunks")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="override Config.COMPUTE_DTYPE")
    p.add_argument("--bf16-adam-nu", action="store_true",
                   help="store Adam second moments in bf16")
    p.add_argument("--bf16-weight-cache", action="store_true",
                   help="bf16 copies of the decoder kernels, refreshed by the Adam write; "
                   "the same bits as without it; requires --compute-dtype bfloat16")
    p.add_argument("--grid", action="store_true",
                   help="train all splits of a (variant, openness) cell as grids over the "
                   "cards (parallel/grid.py) instead of one after another")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    return p


def apply_precision_flags(cfg, args: argparse.Namespace):
    """``cfg`` with ``--compute-dtype``, ``--bf16-adam-nu`` and
    ``--bf16-weight-cache`` applied, as the JAX drivers apply them."""
    if args.compute_dtype:
        cfg = cfg.replace(COMPUTE_DTYPE=args.compute_dtype)
    if args.bf16_adam_nu:
        cfg = cfg.replace(BF16_ADAM_NU=True)
    if args.bf16_weight_cache:
        cfg = cfg.replace(BF16_WEIGHT_CACHE=True)
    return cfg


def grid_devices(device: str) -> List[str]:
    """The devices a grid spreads its runs over: every card for a CUDA
    ``device`` (JAX's ``jax.devices()``), else ``device`` alone."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())] or [device]
    return [device]


def open_run_folders(cfgs) -> List[MetricLogger]:
    """Each run's folder with its ``config.json`` → its metric logger."""
    loggers = []
    for cfg in cfgs:
        os.makedirs(cfg.run_dir(), exist_ok=True)
        cfg.save(os.path.join(cfg.run_dir(), "config.json"))
        loggers.append(MetricLogger(cfg.run_dir(), cfg.to_dict()))
    return loggers


def run_grid_mode(args: argparse.Namespace, base_cfg) -> None:
    """``--grid``: per openness level, decide which splits each variant
    still has to train (before any split is written), write and load those
    splits, then train each variant's splits in grid chunks of
    ``--grid-runs-per-device`` runs."""
    rng = np.random.default_rng(0)
    devices = grid_devices(args.device)
    for n_tr in args.n_training_classes:
        subsets = unique_class_subsets(n_tr, args.n_tests, rng)
        gen_dirs = [f"{args.gen_data_path}_grid{n_tr}_{i}" for i in range(args.n_tests)]

        cfgs_by_variant, todo_by_variant = {}, {}
        for v in args.variants:
            all_cfgs = [
                base_cfg.replace(
                    MODEL_NAME=f"{args.model_name_base}{v}.{n_tr}.{i + 1}",
                    TRAIN_CLASSES=tuple(subsets[i]),
                    Openness=openness(n_tr, N_SUBJECTS),
                    GEN_DATA_PATH=gen_dirs[i],
                    SEED=i,
                    NOTES=f"Grid-parallel ablation run, Variant {v[-1]}",
                )
                for i in range(args.n_tests)
            ]
            cfgs_by_variant[v] = all_cfgs
            todo_by_variant[v] = [
                i for i in range(args.n_tests)
                if args.no_skip_completed or not run_completed(all_cfgs[i].run_dir())
            ]

        data = {}
        for i in sorted(set().union(*todo_by_variant.values())):
            generate_splits(data_path=args.data_path, gen_data_path=gen_dirs[i],
                            train_classes=subsets[i], seed=0, nmax_points=base_cfg.NMAX,
                            nsteps=base_cfg.NSTEPS, crop_step=base_cfg.CROP_STEP, verbose=False)
            data[i] = tuple(RadarCropDataset(split, gen_dirs[i]).load_all()
                            for split in (SPLIT.TRAIN, SPLIT.VALID))

        for v in args.variants:
            todo = todo_by_variant[v]
            if len(todo) < args.n_tests:
                done = sorted(set(range(args.n_tests)) - set(todo))
                print(f"    skipping completed splits {[i + 1 for i in done]}")
            # chunks of runs_per_device × n_dev runs; a chunk the devices
            # do not divide trains its tail on one (parallel.grid.mesh_chunks)
            cap = args.grid_runs_per_device * len(devices)
            for chunk, use_mesh in mesh_chunks(todo, cap, len(devices)):
                print(f"=== grid-training {v} n_tr={n_tr} (splits {[i + 1 for i in chunk]} "
                      f"lockstep{'' if use_mesh else ', unsharded'}) ===")
                # one call per chunk: its trainer (a few GB of weights and
                # moments per run on the card) is freed before the next is built
                run_grid_chunk(args, [cfgs_by_variant[v][i] for i in chunk], VARIATION(v),
                               [data[i] for i in chunk], base_cfg,
                               devices if use_mesh else None)
        del data


def run_grid_chunk(args: argparse.Namespace, cfgs, variation: VARIATION, data,
                   base_cfg, mesh: Optional[List[str]] = None) -> None:
    """Train one chunk of splits through the grid trainer (its runs spread
    over the devices of ``mesh``, else on ``--device``) and write each
    run's folder: ``config.json``, ``metrics.jsonl``, the best weights by
    validation accuracy (checked every ``CHECKPOINT_FREQUENCY`` epochs) in
    the variant's module files, ``discriminator_means.npy`` and
    ``run_complete.json``."""
    trainer = GridPCAATrainer(cfgs, variation, train_sets=[d[0] for d in data],
                              valid_sets=[d[1] for d in data], mesh=mesh, device=args.device)
    loggers = open_run_folders(cfgs)

    for epoch in range(base_cfg.EPOCHS):
        m = trainer.run_epoch(epoch)
        if epoch % base_cfg.CHECKPOINT_FREQUENCY == 0:
            trainer.note_validation(trainer.valid_accuracy())
        for r, logger in enumerate(loggers):
            logger.log({
                "Total Loss Train": float(m["tot_loss"][r]),
                "Discriminator Loss": float(m["d_loss"][r]),
                "Train Accuracy": float(m["train_accuracy"][r]),
            }, step=epoch)

    for r, (cfg, payload, logger) in enumerate(zip(cfgs, trainer.best_run_payloads(), loggers)):
        _checkpoint(cfg.run_dir(), cfg.MODEL_NAME, trainer.mods[r], payload)
        if not VARIANTS[variation].learned_centroids:
            save_array(trainer.states[r].centroids.cpu().numpy(),
                       os.path.join(cfg.run_dir(), "discriminator_means.npy"))
        logger.finish()
        mark_run_completed(cfg.run_dir(), {"best_valid_accuracy": float(trainer._best_accs[r])})
    print(f"    best valid accs: {np.round(trainer._best_accs, 4)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    variations = [VARIATION(v) for v in args.variants]

    base_cfg = default_config(
        DATA_PATH=args.data_path,
        GEN_DATA_PATH=args.gen_data_path,
        MODELS_PATH=args.models_path,
    )
    if args.epochs:
        base_cfg = base_cfg.replace(EPOCHS=args.epochs)
    base_cfg = apply_precision_flags(base_cfg, args)
    if args.grid:
        run_grid_mode(args, base_cfg)
        return

    rng = np.random.default_rng(0)  # splits_seed = 0 (PCAA_ablation.py:1132)
    for n_tr in args.n_training_classes:
        for i, train_classes in enumerate(unique_class_subsets(n_tr, args.n_tests, rng)):
            # SEED=i: the subsets of an openness level get distinct init,
            # shuffle and noise streams, as in the JAX driver
            cfg = base_cfg.replace(
                TRAIN_CLASSES=tuple(train_classes),
                Openness=openness(n_tr, N_SUBJECTS),
                SEED=i,
            )
            todo = []
            for v, variation in zip(args.variants, variations):
                name = f"{args.model_name_base}{v}.{n_tr}.{i + 1}"
                run_cfg = cfg.replace(MODEL_NAME=name, NOTES=f"Ablation run, Variant {v[-1]}")
                if not args.no_skip_completed and run_completed(run_cfg.run_dir()):
                    print(f"=== skipping completed {name} ===")
                else:
                    todo.append((run_cfg, variation))
            if not todo:
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
            for run_cfg, variation in todo:
                name = run_cfg.MODEL_NAME
                print(f"=== training {name} ===")
                out = train_pcaa(run_cfg, variation, wandb_mode=args.wandb_mode,
                                 device=args.device)
                print(
                    f"{name}: best_valid_acc={out['best_valid_accuracy']:.4f} "
                    f"windows/s={out['windows_per_sec']:.1f}"
                )


if __name__ == "__main__":
    main()
