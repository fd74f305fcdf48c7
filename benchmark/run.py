"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
torch.profiler trace of a steady part of the window. The numbers compared
with the plain reference are printed last on standard error and, under
``checks``, last in the line. A run without a CUDA card, or that finds JAX
or the JAX package loaded once the window has closed, prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark.harness import forbidden_modules, load_context, note, process_age_s, run

STARTED = time.perf_counter() - process_age_s()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel libraries are built into build/kernels/ of the
    # checkout; anything else that caches goes under the run's own HOME.
    # One host thread for PyTorch's and OpenMP's CPU work: the hot path is
    # the launching thread, and idle pool threads only contend with it.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

    note("import")
    ctx = load_context(args.workload, args.seed, "cuda")
    want = ctx.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"needs {want} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, compared = run(ctx, args.seconds, bool(args.trace), STARTED)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
