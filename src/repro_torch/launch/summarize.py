"""Summarize experiments/dryrun_torch/*.json into roofline tables: the
port of the reference's ``launch/summarize.py``.

    PYTHONPATH=src python -m repro_torch.launch.summarize [--mesh pod16x16]

A combo run on ``meta`` has no measured peak; its peak column is ``-``.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
DRY = ROOT / "experiments" / "dryrun_torch"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, root: Path = None):
    rows = []
    for fn in sorted((root or DRY).glob(f"*__{mesh}.json")):
        rows.append(json.loads(fn.read_text()))
    return rows


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def table(mesh: str, full: bool = False, rows=None) -> str:
    rows = load(mesh) if rows is None else rows
    by = {(r["arch"], r["shape"]): r for r in rows}
    archs = sorted({r["arch"] for r in rows})
    out = ["| arch | shape | status | compute | memory | collective | "
           "bottleneck | useful_flops | peak_mem/chip |",
           "|---|---|---|---|---|---|---|---|---|"]
    for a in archs:
        for s in SHAPE_ORDER:
            r = by.get((a, s))
            if r is None:
                continue
            if r.get("status") == "skipped":
                out.append(f"| {a} | {s} | SKIP (see DESIGN.md §5) | - | - "
                           f"| - | - | - | - |")
                continue
            rf = r["roofline"]
            ma = r["memory_analysis"]
            mem = ma.get("peak_estimate_tpu_bytes",
                         ma["peak_estimate_bytes"])
            star = "*" if "peak_estimate_tpu_bytes" in ma else ""
            peak = "-" if mem is None else f"{mem/1e9:.2f}GB{star}"
            out.append(
                f"| {a} | {s} | ok | {fmt_s(rf['t_compute_s'])} | "
                f"{fmt_s(rf['t_memory_s'])} | {fmt_s(rf['t_collective_s'])} | "
                f"{rf['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
                f"{peak} |")
    return "\n".join(out)


def bottleneck_stats(mesh: str, rows=None):
    rows = [r for r in (load(mesh) if rows is None else rows)
            if r.get("status") == "ok"]
    c = Counter(r["roofline"]["bottleneck"] for r in rows)
    worst = sorted(rows, key=lambda r: -max(
        r["roofline"]["t_compute_s"], r["roofline"]["t_memory_s"],
        r["roofline"]["t_collective_s"]))
    coll = sorted(rows, key=lambda r: -(r["roofline"]["t_collective_s"]
                                        / max(1e-12, r["roofline"]["t_compute_s"]
                                              + r["roofline"]["t_memory_s"])))
    return c, worst[:5], coll[:5]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16",
                    choices=["pod16x16", "pod2x16x16", "both"])
    args = ap.parse_args(argv)
    meshes = ["pod16x16", "pod2x16x16"] if args.mesh == "both" \
        else [args.mesh]
    for m in meshes:
        print(f"\n### mesh {m}\n")
        print(table(m))
        c, worst, coll = bottleneck_stats(m)
        print(f"\nbottleneck counts: {dict(c)}")
        print("worst absolute step time:",
              [(r['arch'], r['shape']) for r in worst])
        print("most collective-bound:",
              [(r['arch'], r['shape']) for r in coll])


if __name__ == "__main__":
    main()
