"""Benchmark harness of the port: one module per paper table or figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] [--only fig2_lru,...] [--device cpu]

Prints ``name,us_per_call,derived`` CSV; JSON lands in
``experiments/torch/bench/``.  The first run trains the ``tiny-moe``
artifact; later runs read the cache.  Runs on the card unless
``--device cpu`` is given.  The ``kernels`` suite
(``kernels_bench``) on the card checks every hand-written kernel against
its plain version and times it: the reference's rows at its shapes, then
every case of ``chip_smoke.py``'s kernel phases; a kernel that fails its
check fails the suite.  On the CPU it times the plain versions at the
reference's shapes only (no kernel runs there).
"""
from __future__ import annotations

import argparse
import sys
import time

SUITES = ["fig2_lru", "fig2_spec", "table1_quant", "table2_speed",
          "kernels", "serve"]


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
    unknown = sorted((only or set()) - set(SUITES))
    if unknown:
        sys.exit(f"unknown suites {unknown}; available: {SUITES}")

    from repro_torch.benchmarks import (fig2_lru, fig2_spec, kernels_bench,
                                        serve_bench, table1_quant,
                                        table2_speed)

    mods = {"fig2_lru": fig2_lru, "fig2_spec": fig2_spec,
            "table1_quant": table1_quant, "table2_speed": table2_speed,
            "kernels": kernels_bench, "serve": serve_bench}
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
