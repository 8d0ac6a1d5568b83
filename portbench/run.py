"""The benchmark of the PyTorch/CUDA port, one run of one cell.

    python3 portbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<config>.json``) and traffic mix
(``portbench/traffic/<mix>.json``) and its metrics; each metric is read
by ``portbench/metrics/<name>.py``, or, where there is none, by the
module of the name's part before its first dot, and the judge's limits
are ``portbench/limits/<cell>.json``.  The program runs on the card
only: without CUDA, or with fewer cards than the cell asks for, the run
exits non-zero and prints no result.  The last line of standard output
is the result, one JSON object; the numbers the judge compared, each
with its limit, end it and standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# kernel caches of anything that compiles: fixed directories in the
# checkout (the program's own nvcc builds stay where it keeps them,
# src/repro_torch/kernels/build/, also inside the checkout)
CACHE = HERE / ".cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one process drives the card with one host thread: intra-op thread pools
# on the host's shared cores only add jitter to the program's host path
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded where the result is made:
# JAX, and the JAX package and its suite (``repro_torch`` is another name)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        fail(f"{path} is missing")
    return json.loads(path.read_text())


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def reader(name: str):
    """The ``read(run, name)`` of metric ``name``."""
    base = HERE / "metrics"
    path = base / f"{name}.py"
    if path.exists():
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    head = name.split(".")[0]
    if (base / f"{head}.py").exists():
        return importlib.import_module(f"portbench.metrics.{head}").read
    fail(f"no reader for metric {name!r} in {base}")


def load_limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        fail(f"no limits for {workload!r} ({path} is missing)")
    return json.loads(path.read_text())


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, e2e, per, limits: dict, log=print) -> dict:
    """One run (module docstring) on ``device``; returns the result line's
    object, ``device`` filled in by the caller."""
    import torch

    from portbench import harness as H, judge
    from portbench.tracing import Tracer

    drv = H.Runner(cfg, mix, seed, device, log=log)
    if trace:
        drv.tracer = Tracer(cfg, drv.h2d_now)
        drv.tracer.install(drv.ex)
    drv.start()
    # set-up's objects leave the collector's young generations, so that its
    # pauses in the window scan only what the window makes
    gc.collect()
    gc.freeze()
    dev = torch.device(device)
    run = H.Run(cfg=cfg, mix=mix, seconds=seconds)
    if dev.type == "cuda":
        # the window's peak: set-up's dense weights and packing, which no
        # deployment holds while it serves, do not count
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - T_START
    drv.window(run)
    if dev.type == "cuda":
        run.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
    bad = forbidden_modules()
    if bad:
        fail(f"modules {bad} are loaded in the process that measures", 5)
    if trace:
        t = time.perf_counter()
        run.trace = drv.tracer.summary()
        drv.tracer.prof = None
        log(f"trace: {time.perf_counter() - t:.1f} s to reduce; " + json.dumps(
            {k: run.trace[k] for k in ("window_s", "busy_s", "kernel_busy_s",
                                       "h2d_busy_s", "steps", "launches",
                                       "tokens", "h2d_bytes", "calls",
                                       "bound_ms", "device_ms",
                                       "kernels_matched")
             if k in run.trace}))
    log(f"window: {run.window_s:.2f} s, counters " + json.dumps(run.counters))
    picked = H.sample(run, seed)
    drv.free()
    gc.unfreeze()
    values = {}
    for m in (per if trace else e2e):
        v = reader(m["name"])(run, m["name"])
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t = time.perf_counter()
    correct, checks = False, {}
    if picked:
        g = judge.gaps(cfg, seed, [r.prompt for r in picked],
                       [r.tokens for r in picked], device)
        correct, checks = judge.decide(g, limits)
        log(f"judge: {len(picked)} requests, {g['positions']} positions, "
            f"{time.perf_counter() - t:.1f} s")
    attempted = [r for r in run.requests
                 if r.submit_t <= run.t1 and (r.done_t is None or r.done_t >= run.t0)]
    out = {"correct": correct, "attempted": len(attempted),
           "failed": sum(r.failed for r in attempted), "metrics": values,
           "device": {"memory_peak_bytes": run.peak_window_bytes}}
    if trace and run.trace["busy_s"] is not None:
        out["device"].update(busy_s=run.trace["busy_s"],
                             window_s=run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
    wl = cells[args.workload]
    from portbench import harness as H
    from portbench.traffic import generator as TR
    cfg = H.load_config(wl["config"])
    mix = TR.load_mix(wl["traffic"])
    e2e, per = cell_metrics(bench, wl["name"])
    limits = load_limits(wl["name"])

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        fail(f"the cell needs {wl['chips']} CUDA device(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the program (src/repro_torch) cannot be imported: {e}", 4)
    build.compile_all()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    log(f"card: {power_limit()}")
    out = run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace),
                   "cuda", e2e, per, limits, log)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": wl["chips"], **out["device"]}
    for name, v in out["metrics"].items():
        if not math.isfinite(v["value"]):
            fail(f"metric {name} is not finite ({v['value']})", 6)
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    if not out["checks"]:
        log("check: the window finished no request to compare")
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
