"""Validator of the ``--metrics-json`` / ``--trace`` files the port's
launchers write, against the port's schema of record
(:mod:`repro_torch.obs.schema`): the port of the reference's
``tools/check_metrics_schema.py``, with its checks, messages and exit
codes, importing nothing but the standard library and that module.

    python -m repro_torch.obs.check_schema METRICS.json [--trace TRACE.json]

Checks the schema version, the ``mode`` descriptor, the exact namespace
set for that engine/plane/KV-layout combination, the exact key set
inside every namespace and the field layout of every histogram; with
``--trace``, a Chrome ``trace_event`` file for structural sanity and the
request-lifecycle span vocabulary.  Exits 1 listing every violation,
0 when every file passes.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs.schema import (EXEC_KEYS_BY_PLANE, HISTOGRAM_FIELDS,
                                    JIT_KEYS, OFFLOAD_KEYS, REQUEST_KEYS,
                                    ROOFLINE_KEYS, SCHEMA_VERSION, SPEC_KEYS,
                                    expected_namespaces)

# histograms serialize as nested dicts; everything else is scalar-ish
HISTOGRAM_METRICS = {("step", "wall_ms"), ("request", "queue_wait_steps"),
                     ("request", "gen_tokens"), ("spec", "proposed"),
                     ("spec", "accepted")}

# span/instant names every traced continuous-serve run must carry
REQUIRED_TRACE_NAMES = {"submit", "queue_wait", "decode", "finish"}


def expected_for_mode(mode):
    """``mode`` descriptor (the dict serve.py embeds) -> exact
    ``{namespace: key set}`` the file's metrics section must carry."""
    engine = mode.get("engine")
    timing = bool(mode.get("timing", False))
    plane = mode.get("plane", "plain")
    roofline = bool(mode.get("roofline", timing))
    # read via .get: files from before the speculation / prefix-caching
    # PRs carry none of these fields and must keep validating
    speculative = bool(mode.get("speculative", False))
    prefix_cache = bool(mode.get("prefix_cache", False))
    kv_host = bool(mode.get("kv_host", False))
    if engine == "continuous":
        # defaults True: every ContinuousEngine registers the faults
        # collector, so files predating the mode field still validate
        return expected_namespaces(
            kv_layout=mode.get("kv_layout", "dense"),
            offloaded=bool(mode.get("offloaded", False)),
            timing=timing, plane=plane, roofline=roofline,
            speculative=speculative, prefix_cache=prefix_cache,
            kv_host=kv_host, faults=bool(mode.get("faults", True)))
    if engine == "offload":
        # the batch OffloadEngine has no scheduler/KV-slot plane or step
        # loop — it carries traffic + jit always, request/exec/roofline
        # when timing is on, spec when draft-and-verify decoding ran
        # (no faults namespace: the fault-injection plane lives in the
        # continuous engine's request lifecycle, DESIGN.md §14)
        out = {"offload": OFFLOAD_KEYS, "jit": JIT_KEYS}
        if speculative:
            out["spec"] = SPEC_KEYS
        if timing:
            out["request"] = REQUEST_KEYS
            out["exec"] = EXEC_KEYS_BY_PLANE[plane]
            if roofline:
                out["roofline"] = ROOFLINE_KEYS
        return out
    raise ValueError(f"unknown mode.engine {engine!r}")


def check_metrics(path: Path):
    errors = []
    doc = json.loads(path.read_text())
    for field in ("schema_version", "mode", "metrics"):
        if field not in doc:
            errors.append(f"{path}: missing top-level field {field!r}")
    if errors:
        return errors
    if doc["schema_version"] != SCHEMA_VERSION:
        errors.append(f"{path}: schema_version {doc['schema_version']} != "
                      f"{SCHEMA_VERSION}")
    mode = doc["mode"]
    for field in ("engine", "arch", "offloaded", "timing", "plane",
                  "roofline"):
        if field not in mode:
            errors.append(f"{path}: mode missing {field!r} (got "
                          f"{sorted(mode)})")
    if errors:
        return errors
    if mode["engine"] == "continuous" and "kv_layout" not in mode:
        return [f"{path}: continuous mode missing 'kv_layout'"]

    expected = expected_for_mode(mode)
    metrics = doc["metrics"]
    if set(metrics) != set(expected):
        errors.append(f"{path}: namespaces {sorted(metrics)} != expected "
                      f"{sorted(expected)} for mode {mode}")
    for ns in sorted(set(metrics) & set(expected)):
        got, want = set(metrics[ns]), set(expected[ns])
        if got != want:
            missing, extra = sorted(want - got), sorted(got - want)
            errors.append(f"{path}: namespace {ns!r}: missing={missing} "
                          f"extra={extra}")
    for ns, key in sorted(HISTOGRAM_METRICS):
        val = metrics.get(ns, {}).get(key)
        if val is None:
            continue  # namespace absent is already reported above
        if not isinstance(val, dict) or set(val) != HISTOGRAM_FIELDS:
            errors.append(f"{path}: {ns}.{key} should be a histogram with "
                          f"fields {sorted(HISTOGRAM_FIELDS)}, got {val!r}")
    # timed runs must have actually measured something
    if mode["timing"] and mode["engine"] == "continuous":
        step = metrics.get("step", {})
        if not step.get("timed"):
            errors.append(f"{path}: timing mode but step.timed == "
                          f"{step.get('timed')!r} (no steps measured)")
    return errors


def check_trace(path: Path):
    errors = []
    doc = json.loads(path.read_text())
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return [f"{path}: traceEvents missing or empty"]
    names_by_ph = {}
    for i, ev in enumerate(events):
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                errors.append(f"{path}: event {i} missing {field!r}: {ev}")
                break
        else:
            names_by_ph.setdefault(ev["ph"], set()).add(ev["name"])
            if ev["ph"] in ("X", "i") and "ts" not in ev:
                errors.append(f"{path}: event {i} ({ev['name']}) has no ts")
            if ev["ph"] == "X" and ev.get("dur", -1.0) < 0.0:
                errors.append(f"{path}: event {i} ({ev['name']}) has "
                              f"negative/missing dur")
    meta = names_by_ph.get("M", set())
    if not {"process_name", "thread_name"} <= meta:
        errors.append(f"{path}: missing process/thread metadata events "
                      f"(got {sorted(meta)})")
    seen = names_by_ph.get("X", set()) | names_by_ph.get("i", set())
    missing = REQUIRED_TRACE_NAMES - seen
    if missing:
        errors.append(f"{path}: request lifecycle spans missing: "
                      f"{sorted(missing)}")
    if not any(n.startswith("prefill[") for n in names_by_ph.get("X", ())):
        errors.append(f"{path}: no prefill[lo:hi) chunk spans recorded")
    if not any(n.startswith("step ") for n in names_by_ph.get("X", ())):
        errors.append(f"{path}: no per-step spans recorded")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.check_schema")
    ap.add_argument("metrics", type=Path,
                    help="a --metrics-json file from launch/serve.py")
    ap.add_argument("--trace", type=Path, default=None,
                    help="optionally also validate a --trace file")
    args = ap.parse_args(argv)

    errors = check_metrics(args.metrics)
    n_checked = 1
    if args.trace is not None:
        errors += check_trace(args.trace)
        n_checked += 1
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    print(f"check_metrics_schema: {n_checked} file(s) OK "
          f"(schema v{SCHEMA_VERSION})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
