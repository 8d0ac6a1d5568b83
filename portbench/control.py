"""The readings the judge's limits are set from; never run by the
benchmark's own runs.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds S \
        [--fault-seeds 1,2 --fault-seconds F] [--out gaps.jsonl]

For each seed, in one process: the cell's program built from the seed,
warmed up and driven for a window at the cell's own load, its finished
requests sampled as a run samples them.  For a seed in ``--fault-seeds``
the same engine then serves on for ``--fault-seconds`` with a wrong
expert record planted in the pool (:func:`wrong_expert_slots`), and the
requests submitted and finished under it are sampled too.  The program
is freed; then the judge reads the served tokens (the lower readings),
the tokens that the reference computed in float8 e4m3 puts first at the
same positions (the control, the upper readings) and the faulted
program's tokens, and each is held to the cell's limits by
``judge.decide``: the control and the fault have to come out as not
correct.  One JSON line per seed on standard output; with ``--out`` the
gaps at every position too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def wrong_expert_slots():
    """A wrong record in the expert pool, an index off by one: every routed
    expert of a decode step is read from the record that holds the next
    access's expert (the token's next expert, or the next token's first),
    as a stale slot table would have it."""
    import torch

    from repro_torch.core import expert_pool as EP
    acquire = EP.acquire

    def wrong(store, st, l, ids, active=None, **kw):
        return torch.roll(acquire(store, st, l, ids, active, **kw), -1)
    EP.acquire = wrong
    try:
        yield
    finally:
        EP.acquire = acquire


def readings(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             device, fault_seconds: float = 0.0, log=None) -> dict:
    """One seed's readings (module docstring) on ``device``."""
    import torch

    from portbench import harness as H, judge
    t = time.perf_counter()
    drv = H.Runner(cfg, mix, seed, device, log=log)
    drv.start()
    run = H.Run(cfg=cfg, mix=mix, seconds=seconds)
    drv.window(run)
    picked = H.sample(run, seed)
    faulted = []
    if fault_seconds:
        t_fault = time.perf_counter()
        frun = H.Run(cfg=cfg, mix=mix, seconds=fault_seconds)
        with wrong_expert_slots():
            drv.window(frun)
        frun.requests = [r for r in frun.requests if r.submit_t >= t_fault]
        faulted = H.sample(frun, seed)
    drv.free()
    g = judge.gaps(cfg, seed, [r.prompt for r in picked],
                   [r.tokens for r in picked], device, control=True)
    out = {"seed": seed, "requests": len(picked)}
    out["program"] = {k: g[k] for k in ("served_gap", "mean_gap", "positions")}
    out["program"]["correct"] = judge.decide(g, limits)[0]
    out["control"] = dict(g["control"], correct=judge.decide(g["control"], limits)[0])
    if faulted:
        f = judge.gaps(cfg, seed, [r.prompt for r in faulted],
                       [r.tokens for r in faulted], device)
        out["fault"] = dict(f, requests=len(faulted),
                            correct=judge.decide(f, limits)[0])
    elif fault_seconds:
        out["fault"] = {"requests": 0, "correct": False}
    out["gaps"] = {"served": g["served_gaps"], "control": g["control_gaps"]}
    out["seconds"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--fault-seconds", type=float, default=25.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness as H, run as R
    from portbench.traffic import generator as TR
    if not torch.cuda.is_available():
        R.fail("the control runs on the card", 3)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.compile_all()
    wl = {w["name"]: w for w in R.load_benchmark()["workloads"]}[args.workload]
    cfg, mix = H.load_config(wl["config"]), TR.load_mix(wl["traffic"])
    limits = R.load_limits(args.workload)
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    log = lambda m: print(m, file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cfg, mix, limits, seed, args.seconds, "cuda",
                       args.fault_seconds if seed in fault_seeds else 0.0, log)
        gaps = out.pop("gaps")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed,
                                    **gaps}) + "\n")
        print(json.dumps({"workload": args.workload, **out}), flush=True)


if __name__ == "__main__":
    main()
