"""The dry run's two tables over its JSONs, on one card (the port of
`benchmarks/roofline_table.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --out-dir results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.roofline_table \
        --dir results/dryrun_torch

Every number is counted on fake tensors on the CPU and set against the
peaks of one H100 (`utils.roofline`); no time in them was measured.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.utils.roofline import CARD


def load(results_dir="results/dryrun_torch"):
    """{(arch, shape, mode): record} of every JSON in results_dir."""
    out = {}
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r.get("mode", "apibcd"))] = r
    return out


def _fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(results, mode="apibcd"):
    lines = [
        "| arch | shape | compute | memory | bound | dominant | "
        "MODEL/counted flops | counted flops | HBM bytes |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            r = results.get((a, s, mode))
            if r is None:
                lines.append(f"| {a} | {s} | - | - | - | MISSING | | | |")
                continue
            if "skipped" in r:
                lines.append(f"| {a} | {s} | — | — | — | *skipped* "
                             f"({r['skipped'][:40]}…) | | | |")
                continue
            rl = r["roofline"]
            ratio = r.get("useful_flop_ratio")
            lines.append(
                f"| {a} | {s} | {_fmt_s(rl['compute_s'])} | "
                f"{_fmt_s(rl['memory_s'])} | "
                f"{_fmt_s(max(rl['compute_s'], rl['memory_s']))} | "
                f"**{rl['dominant']}** | {ratio:.2f} | {rl['flops']:.2e} | "
                f"{rl['hbm_bytes']:.2e} |")
    return "\n".join(lines)


def dryrun_table(results, mode="apibcd"):
    lines = [
        "| arch | shape | count s | params | args GB | output GB | "
        "temp GB | fits one card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            r = results.get((a, s, mode))
            if r is None or "skipped" in r:
                status = "skipped" if (r and "skipped" in r) else "missing"
                lines.append(f"| {a} | {s} | — | — | — | — | — | "
                             f"*{status}* |")
                continue
            mem = r["memory_analysis"]
            arg = mem["argument_size_in_bytes"] / 1e9
            out = mem["output_size_in_bytes"] / 1e9
            lines.append(
                f"| {a} | {s} | {r['count_s']:.0f} | "
                f"{r['params'] / 1e9:.2f}B | {arg:.2f} | {out:.2f} | "
                f"not measured | {'yes' if r['fits_one_card'] else 'no'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    results = load(args.dir)
    n_ok = sum(1 for r in results.values() if "skipped" not in r)
    n_skip = sum(1 for r in results.values() if "skipped" in r)
    print(f"# Dry-run aggregate: {n_ok} counted, {n_skip} skipped, "
          f"{len(results)} total (fake tensors on the CPU; bounds against "
          f"the {CARD})\n")
    for mode in sorted({m for _, _, m in results}):
        print(f"\n## Roofline — {mode}, 1 card\n")
        print(roofline_table(results, mode))
        print(f"\n## Dry-run details — {mode}, 1 card\n")
        print(dryrun_table(results, mode))


if __name__ == "__main__":
    main()
