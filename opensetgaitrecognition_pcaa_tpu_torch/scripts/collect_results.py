"""Open-set metrics of every run folder, gathered into one table.

The port's copy of ``scripts/collect_results.py`` (standard library only;
the port imports nothing of the root ``scripts/``): rows of (run, variant,
n_train, split, k) with the metrics of each ``naive_seq_log_<k>.json`` and
``ensemble_ood_log.json`` (k = ``ens``), then the means over splits per
(variant, n_train, k), the paper's table cells.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.collect_results \
        --models-path models [--markdown out.md] [--json rows.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict
from typing import Optional, Sequence

RUN_RE = re.compile(r"(?P<base>.+?)(?P<variant>V\d)?\.(?P<n_tr>\d+)\.(?P<split>\d+)$")
LOG_RE = re.compile(r"naive_seq_log_(?P<k>\d+)\.json$")


def collect(models_path: str):
    rows = []
    for run in sorted(os.listdir(models_path)):
        run_dir = os.path.join(models_path, run)
        if not os.path.isdir(run_dir):
            continue
        m = RUN_RE.match(run)
        meta = m.groupdict() if m else {"base": run, "variant": None, "n_tr": "?", "split": "?"}
        for f in sorted(os.listdir(run_dir)):
            lm = LOG_RE.match(f)
            if lm:
                k = int(lm.group("k"))
            elif f == "ensemble_ood_log.json":  # ORCED ensemble metrics
                k = "ens"
            else:
                continue
            with open(os.path.join(run_dir, f)) as fh:
                log = json.load(fh)
            rows.append(
                {
                    "run": run,
                    "variant": meta["variant"] or "?",
                    "n_train": meta["n_tr"],
                    "split": meta["split"],
                    "k": k,
                    **{
                        k2: log[k2]
                        for k2 in ("accuracy", "f1_micro", "f1_macro", "f1_weighted")
                        if k2 in log
                    },
                }
            )
    return rows


def to_markdown(rows) -> str:
    if not rows:
        return "(no results found)\n"
    header = "| run | variant | n_train | split | k | accuracy | f1_micro | f1_macro | f1_weighted |"
    sep = "|" + "---|" * 9
    lines = [header, sep]
    for r in sorted(rows, key=lambda r: (r["variant"], r["n_train"], r["split"], str(r["k"]))):
        lines.append(
            f"| {r['run']} | {r['variant']} | {r['n_train']} | {r['split']} "
            f"| {r['k']} | {r.get('accuracy', float('nan')):.4f} "
            f"| {r.get('f1_micro', float('nan')):.4f} "
            f"| {r.get('f1_macro', float('nan')):.4f} "
            f"| {r.get('f1_weighted', float('nan')):.4f} |"
        )

    # per (variant, n_train, k) means across splits — the paper's table
    # cells. Runs whose names don't parse (n_train '?') are listed above
    # but EXCLUDED here: lumping them into one ('?', '?') group would
    # silently average unrelated runs together.
    groups = defaultdict(list)
    skipped = sorted({r["run"] for r in rows if r["n_train"] == "?"})
    for r in rows:
        if r["n_train"] != "?":
            groups[(r["variant"], r["n_train"], r["k"])].append(r)
    lines.append("\n### Means across splits\n")
    if skipped:
        lines.append(
            f"(excluded from means — unparseable run names: "
            f"{', '.join(skipped)})\n"
        )
    lines.append("| variant | n_train | k | accuracy | f1_micro | f1_macro | f1_weighted |")
    lines.append("|" + "---|" * 7)
    for (v, n, k), rs in sorted(groups.items(), key=lambda it: tuple(map(str, it[0]))):
        def mean(key):
            vals = [r[key] for r in rs if key in r]
            return sum(vals) / len(vals) if vals else float("nan")

        lines.append(
            f"| {v} | {n} | {k} | {mean('accuracy'):.4f} | {mean('f1_micro'):.4f} "
            f"| {mean('f1_macro'):.4f} | {mean('f1_weighted'):.4f} |"
        )
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models-path", default="models")
    p.add_argument("--markdown", default=None, help="write a markdown table here")
    p.add_argument("--json", default=None, help="write raw rows here")
    args = p.parse_args(argv)

    rows = collect(args.models_path)
    md = to_markdown(rows)
    print(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
