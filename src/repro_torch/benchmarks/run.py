"""Benchmark harness of the port: one module per paper table or figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] [--only fig2_lru,...] [--device cpu]

Prints ``name,us_per_call,derived`` CSV; JSON lands in
``experiments/torch/bench/``.  The first run trains the ``tiny-moe``
artifact; later runs read the cache.  Runs on the card unless
``--device cpu`` is given.  The reference's ``kernels`` suite is
replaced by the kernel phases of ``chip_smoke.py`` and is refused.
"""
from __future__ import annotations

import argparse
import sys
import time

SUITES = ["fig2_lru", "fig2_spec", "table1_quant", "table2_speed", "serve"]
REFUSED = {
    "kernels": "the kernel phases of chip_smoke.py check and time every "
               "kernel on the card; run `python3 chip_smoke.py`",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced sizes/grids")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of suites")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    refused = sorted((only or set()) & set(REFUSED))
    if refused:
        sys.exit("; ".join(f"suite {n!r} is not run here: {REFUSED[n]}"
                           for n in refused))
    unknown = sorted((only or set()) - set(SUITES))
    if unknown:
        sys.exit(f"unknown suites {unknown}; available: {SUITES}")

    from repro_torch.benchmarks import (fig2_lru, fig2_spec, serve_bench,
                                        table1_quant, table2_speed)

    mods = {"fig2_lru": fig2_lru, "fig2_spec": fig2_spec,
            "table1_quant": table1_quant, "table2_speed": table2_speed,
            "serve": serve_bench}
    print("name,us_per_call,derived")
    failures = []
    for name in SUITES:
        if only and name not in only:
            continue
        t0 = time.time()
        try:
            mods[name].run(quick=args.quick, device=args.device)
            print(f"# [{name}] done in {time.time() - t0:.1f}s",
                  file=sys.stderr)
        except Exception as e:  # keep the harness going, report at the end
            failures.append((name, repr(e)))
            print(f"# [{name}] FAILED: {e!r}", file=sys.stderr)
    if failures:
        sys.exit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
