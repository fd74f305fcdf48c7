"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the numbers the comparison computes for
the program, for the control (the plain reference in TF32, the nearest
precision below the configuration's f32, put in the program's place) and
for each planted fault.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        [--modes program control half_batch] [--out calibrate.jsonl]

The program's readings need no measured window: a training cell's come
from its set-up's first three steps, an evaluation cell's from one call
over the whole split (``segment()``). One JSON line per seed and mode,
with the per-leaf and per-step detail a training cell module's ``explain``
gives.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark.harness import cell_module, free_device, load_context


def readings(ctx, mode: str, ref_cache: dict):
    """The numbers ``compare`` gives for one mode (a training cell's per-leaf
    and per-step detail under "leaves"). The control reuses the rows and
    noise of its seed's program mode, which has to come first."""
    drv = cell_module(ctx)
    if mode == "control":
        prog = None
    else:
        cell = drv.Cell(ctx)
        cell.segment()  # an eval cell's answers come from a call; a training cell's from set-up
        prog = cell.readings()
        cell.free()
        del cell
        free_device()
    key = ctx.seed
    if key not in ref_cache:
        ref_cache.clear()
        ref_cache[key] = (drv.reference(ctx, prog), prog)
    ref, prog0 = ref_cache[key]
    if mode == "control":
        prog = drv.reference(ctx, prog0, exact=False)
    nums = dict(drv.compare(prog, ref))
    if hasattr(drv, "explain"):
        nums["leaves"] = drv.explain(prog, ref)
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["program", "control"])
    ap.add_argument("--out", default="calibrate.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cache: dict = {}
    with open(args.out, "a") as out:
        for seed in args.seeds:
            for mode in args.modes:
                t = time.perf_counter()
                fault = None if mode in ("program", "control") else mode
                ctx = load_context(args.workload, seed, "cuda", fault=fault)
                nums = readings(ctx, mode, cache)
                line = {"workload": args.workload, "seed": seed, "mode": mode, **nums,
                        "seconds": time.perf_counter() - t}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
