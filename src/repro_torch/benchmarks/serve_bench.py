"""Serving benchmarks (the port of the reference's
``benchmarks/serve_bench.py``): continuous against static batching
throughput, chunked-prefill decode latency, and dense slot KV against
block pages.

Workload 1 (throughput): N requests with mixed prompt lengths and mixed
output budgets, all backlogged at t=0.  The static baseline serves FCFS
groups of ``max_slots`` requests through ``ServeEngine.serve_batch``,
every group holding all its slots until its longest member finishes; the
continuous engine releases a slot the step its request finishes and
admits the next request at once.  Static prefill is a different program
(the dispatch MoE with capacity drops), so the two token counts are held
within 25 %, not equal.

Workload 2 (latency): short requests decode while long prompts arrive
into freed slots.  Unchunked admission prefills a whole long prompt in
one step, stalling every in-flight decode; with ``prefill_chunk`` the
prompt goes in budgeted chunks across steps.  Measured on the plain and
the packed plane: the inter-token latency of the decode tokens (p50,
p95).  Greedy tokens must be equal with and without chunking, and on the
packed plane the h2d counters too (prefill streams from the host store).

Workload 3 (KV layout): the same long-prompt traffic on dense slot rings
and on pages at a generous slot width.  Tokens must be equal, and pages
must reserve fewer peak KV positions.

Every row names the device it ran on.  Times come from the host clock
around work that ends in a device read (each step reads its sampled
tokens back), best of alternating passes after a warm-up pass.  Results
go to ``experiments/torch/bench/serve_bench.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench [--quick] [--device cpu]

The reference's ``telemetry_overhead``, ``prefix_reuse``,
``overload_preempt``, ``chaos`` and ``zoo`` scenarios are not ported
(ROADMAP queue 1 items 7, 5, 5, 5 and 6): they raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.configs.base import OffloadSpec
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import ExpertOverlapPolicy


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_workload(cfg, n_requests, seed=0, smoke=False):
    """Interactive traffic: mostly short replies, a tail of long
    generations (what makes static batching serialise short requests
    behind long ones); prompt lengths from a small discrete set."""
    rng = np.random.default_rng(seed)
    lengths = (4, 8) if smoke else (8, 16, 24, 32)
    short, long_ = ((2, 8), (8, 12)) if smoke else ((4, 16), (48, 64))
    reqs = []
    for _ in range(n_requests):
        s = int(rng.choice(lengths))
        prompt = rng.integers(1, cfg.vocab_size, s).astype(np.int32)
        lo, hi = short if rng.random() < 0.75 else long_
        reqs.append((prompt, int(rng.integers(lo, hi + 1))))
    return reqs


def run_static(eng, workload, max_slots):
    """FCFS groups of ``max_slots`` through the static engine; returns
    the tokens generated."""
    toks = 0
    for i in range(0, len(workload), max_slots):
        group = [Request(p, m) for p, m in workload[i: i + max_slots]]
        for r in eng.serve_batch(group):
            toks += len(r.completed)
    return toks


def run_continuous(eng, workload):
    """Submit and drain one pass of the workload; returns (tokens, steps)
    of THIS pass (the engine is shared between the warm-up and the timed
    passes)."""
    t_before = eng.stats()["tokens"]
    s_before = eng.step_count
    d_before = len(eng.sched.finished)
    for p, m in workload:
        eng.submit(p, m)
    eng.run(max_steps=100_000)
    assert len(eng.sched.finished) - d_before == len(workload), \
        "continuous engine dropped requests"
    return eng.stats()["tokens"] - t_before, eng.step_count - s_before


# ----------------------------------------------------------------------
# workload 2: chunked prefill against whole-prompt admission
def make_latency_workload(cfg, max_slots, smoke=False, seed=0):
    """Short decode-heavy requests with long prompts behind them (FCFS
    order): the first ``max_slots`` shorts fill the slots; every long
    then admits into a freed slot while the other rows decode."""
    rng = np.random.default_rng(seed)
    if smoke:
        n_short, short_len, short_news = 4, 6, (5, 9)
        n_long, long_len, long_new = 1, 24, 3
    else:
        # long prompts must dwarf a decode step, and short budgets are
        # staggered so slots free one at a time and every long admits
        # into a batch still decoding
        n_short, short_len, short_news = 6, 8, (10, 26)
        n_long, long_len, long_new = 4, 120, 2
    shorts = [(rng.integers(1, cfg.vocab_size, short_len).astype(np.int32),
               int(rng.integers(*short_news))) for _ in range(n_short)]
    longs = [(rng.integers(1, cfg.vocab_size, long_len).astype(np.int32),
              long_new) for _ in range(n_long)]
    out = shorts[:max_slots]
    rest = shorts[max_slots:]
    for i in range(max(len(longs), len(rest))):
        if i < len(longs):
            out.append(longs[i])
        if i < len(rest):
            out.append(rest[i])
    return out


def _drive_latency(eng, workload):
    """One pass with each step's wall time charged to every DECODE token
    it emitted (first tokens measure time to first token, not stalls).
    Returns (samples ms, tokens per request, wall s, engine)."""
    reqs = [eng.submit(p, m) for p, m in workload]
    samples_ms = []
    t0_all = time.perf_counter()
    while eng.sched.has_waiting or eng.sched.n_running:
        before = [len(r.generated) for r in reqs]
        t0 = time.perf_counter()
        eng.step()
        dt_ms = (time.perf_counter() - t0) * 1e3
        decode_emits = sum(1 for r, b in zip(reqs, before)
                           if len(r.generated) > b and b > 0)
        samples_ms += [dt_ms] * decode_emits
        assert eng.step_count < 100_000
    wall = time.perf_counter() - t0_all
    assert all(r.state == "finished" for r in reqs)
    return samples_ms, [r.generated for r in reqs], wall, eng


def run_chunked_latency(params, cfg, *, chunk, smoke=False, offload=None,
                        max_slots=2, slot_len=None, seed=0, device=None):
    """Decode inter-token latency, unchunked against chunked admission,
    on the same workload and engine configuration (plain plane, or the
    packed one with ``offload``).  Asserts token parity and, packed,
    equal h2d counters.  Returns the result row."""
    dev = resolve_device(device) if offload is None else offload.device
    slot_len = slot_len or (48 if smoke else 128)
    workload = make_latency_workload(cfg, max_slots, smoke=smoke, seed=seed)

    def make_engine(prefill_chunk):
        return ContinuousEngine(
            None if offload is not None else params, cfg,
            max_slots=max_slots, slot_len=slot_len, eos_id=None,
            prefill_chunk=prefill_chunk, offload=offload, device=dev)

    results, counters = {}, {}
    for name, c in (("unchunked", None), ("chunked", chunk)):
        _drive_latency(make_engine(c), workload)  # warm-up
        samples, toks, wall, eng = _drive_latency(make_engine(c), workload)
        n_tok = sum(len(t) for t in toks)
        results[name] = {"tokens": toks, "tok_s": n_tok / wall,
                         "p50_ms": float(np.percentile(samples, 50)),
                         "p95_ms": float(np.percentile(samples, 95))}
        if offload is not None:
            # each engine owns its pool state: this pass's traffic alone
            s = eng.stats()
            counters[name] = {
                "h2d_bytes": s["offload_bytes_h2d"],
                "demand_loads": s["offload_demand_loads"],
                "spec_loads": s["offload_spec_loads"],
                "hit_ratio": s["offload_hits"] / max(
                    1, s["offload_hits"] + s["offload_demand_loads"])}
    if offload is not None:
        assert counters["chunked"] == counters["unchunked"], \
            f"chunking changed packed h2d counters: {counters}"
    assert results["chunked"]["tokens"] == results["unchunked"]["tokens"], \
        "chunked prefill changed generated tokens"
    un, ch = results["unchunked"], results["chunked"]
    row = {
        "name": "serve_bench",
        "scenario": ("chunked_prefill_packed" if offload is not None
                     else "chunked_prefill"),
        "device": _device_name(dev),
        "prefill_chunk": chunk, "max_slots": max_slots,
        "slot_len": slot_len,
        "unchunked_tok_s": un["tok_s"], "chunked_tok_s": ch["tok_s"],
        "unchunked_p50_ms": un["p50_ms"], "chunked_p50_ms": ch["p50_ms"],
        "unchunked_p95_ms": un["p95_ms"], "chunked_p95_ms": ch["p95_ms"],
        "p95_speedup": un["p95_ms"] / max(1e-9, ch["p95_ms"]),
        "token_parity": True,
    }
    if offload is not None:
        row.update({"h2d_bytes": counters["chunked"]["h2d_bytes"],
                    "hit_ratio": counters["chunked"]["hit_ratio"],
                    "counters_identical": True})
    tag = "packed " if offload is not None else ""
    print(f"[serve_bench] {tag}inter-token p50/p95: unchunked "
          f"{un['p50_ms']:.2f}/{un['p95_ms']:.2f} ms -> chunked "
          f"{ch['p50_ms']:.2f}/{ch['p95_ms']:.2f} ms "
          f"(p95 {row['p95_speedup']:.3f}x)")
    return row


# ----------------------------------------------------------------------
# workload 3: pages against dense slot rings
def run_paged_kv(params, cfg, *, smoke=False, max_slots=4, seed=0,
                 kv_page=None, device=None):
    """Dense slot KV against block-paged KV over the same long-prompt
    workload at a generous slot width (slots provisioned for the worst
    case): equal greedy tokens, and fewer peak KV positions reserved on
    pages.  Best of alternating passes."""
    dev = resolve_device(device)
    slot_len = 96 if smoke else 384
    kv_page = kv_page or (16 if smoke else 32)
    workload = make_latency_workload(cfg, max_slots, smoke=smoke, seed=seed)

    def make_engine(paged):
        kw = dict(kv_page=kv_page) if paged else {}
        return ContinuousEngine(params, cfg, max_slots=max_slots,
                                slot_len=slot_len, eos_id=None, device=dev,
                                **kw)

    n_passes = 2 if smoke else 3
    results = {}
    for name, paged in (("dense", False), ("paged", True)):
        _drive_latency(make_engine(paged), workload)  # warm-up
        results[name] = {"tok_s": 0.0, "p50_ms": np.inf, "p95_ms": np.inf}
    for _ in range(n_passes):
        for name, paged in (("dense", False), ("paged", True)):
            samples, toks, wall, eng = _drive_latency(make_engine(paged),
                                                      workload)
            n_tok = sum(len(t) for t in toks)
            r = results[name]
            r["tokens"] = toks
            r["peak_kv"] = eng.stats()["kv_peak_positions_reserved"]
            r["tok_s"] = max(r["tok_s"], n_tok / wall)
            r["p50_ms"] = min(r["p50_ms"], float(np.percentile(samples, 50)))
            r["p95_ms"] = min(r["p95_ms"], float(np.percentile(samples, 95)))
    dense, paged = results["dense"], results["paged"]
    assert paged["tokens"] == dense["tokens"], \
        "paged KV changed generated tokens"
    assert paged["peak_kv"] < dense["peak_kv"], \
        "paged KV should reserve fewer positions than slot provisioning"
    row = {
        "name": "serve_bench", "scenario": "paged_kv",
        "device": _device_name(dev),
        "max_slots": max_slots, "slot_len": slot_len, "kv_page": kv_page,
        "dense_tok_s": dense["tok_s"], "paged_tok_s": paged["tok_s"],
        "dense_p50_ms": dense["p50_ms"], "paged_p50_ms": paged["p50_ms"],
        "dense_p95_ms": dense["p95_ms"], "paged_p95_ms": paged["p95_ms"],
        "tok_s_speedup": paged["tok_s"] / max(1e-9, dense["tok_s"]),
        "p95_speedup": dense["p95_ms"] / max(1e-9, paged["p95_ms"]),
        "dense_peak_kv_positions": int(dense["peak_kv"]),
        "paged_peak_kv_positions": int(paged["peak_kv"]),
        "kv_memory_ratio": dense["peak_kv"] / max(1, paged["peak_kv"]),
        "token_parity": True,
    }
    print(f"[serve_bench] paged KV (slot_len {slot_len}, page {kv_page}): "
          f"dense {row['dense_tok_s']:.2f} tok/s p95 "
          f"{row['dense_p95_ms']:.2f} ms -> paged {row['paged_tok_s']:.2f} "
          f"tok/s p95 {row['paged_p95_ms']:.2f} ms "
          f"({row['kv_memory_ratio']:.2f}x less peak KV)")
    return row


# ----------------------------------------------------------------------
def _not_ported(scenario: str, item: int):
    raise NotImplementedError(
        f"serve_bench scenario {scenario!r} is not ported yet (ROADMAP "
        f"queue 1, item {item})")


def run_telemetry_overhead(*args, **kwargs):
    _not_ported("telemetry_overhead", 7)


def run_prefix_reuse(*args, **kwargs):
    _not_ported("prefix_reuse", 5)


def run_overload_preempt(*args, **kwargs):
    _not_ported("overload_preempt", 5)


def run_chaos(*args, **kwargs):
    _not_ported("chaos", 5)


def run_zoo(*args, **kwargs):
    _not_ported("zoo", 6)


# ----------------------------------------------------------------------
def run(quick=False, trained=False, n_requests=None, max_slots=4,
        slot_len=None, seed=0, overlap=False, prefill_chunk=None,
        device=None):
    """The ported scenarios on ``tiny-moe`` (random weights from ``seed``,
    or the trained recipe's with ``trained``), on the card unless
    ``device="cpu"``.  Returns the rows and writes them with
    ``common.emit``."""
    dev = resolve_device(device)
    if trained:
        params, cfg = common.get_trained_tiny_moe(device=dev)
    else:
        cfg = get_config("tiny-moe")
        params = T.init_model(cfg, seed=seed, device=dev)

    n = n_requests or (6 if quick else 24)
    slot_len = slot_len or (64 if quick else 128)
    workload = make_workload(cfg, n, seed=seed, smoke=quick)
    # FCFS for the headline: expert-overlap admission reads the routing
    # every step, which pays only where expert loads are expensive
    policy = ExpertOverlapPolicy(params, cfg) if overlap else None
    static_eng = ServeEngine(params, cfg, SamplerConfig(kind="greedy"),
                             device=dev)
    cont_eng = ContinuousEngine(params, cfg, max_slots=max_slots,
                                slot_len=slot_len, policy=policy, device=dev)

    # warm-up once per engine, then best of alternating timed passes
    run_static(static_eng, workload, max_slots)
    run_continuous(cont_eng, workload)
    n_passes = 2 if quick else 3
    t_static = t_cont = np.inf
    for _ in range(n_passes):
        t0 = time.perf_counter()
        static_toks = run_static(static_eng, workload, max_slots)
        _sync(dev)
        t_static = min(t_static, time.perf_counter() - t0)
        t0 = time.perf_counter()
        cont_toks, cont_steps = run_continuous(cont_eng, workload)
        _sync(dev)
        t_cont = min(t_cont, time.perf_counter() - t0)

    # the two differ only through EOS stops and the static prefill's
    # capacity drops, so the counts may differ by a few tokens
    drift = abs(cont_toks - static_toks) / max(1, cont_toks)
    assert drift < 0.25, \
        f"token accounting drift too large: {cont_toks} vs {static_toks}"
    tps_static, tps_cont = static_toks / t_static, cont_toks / t_cont
    speedup = tps_cont / tps_static
    results = [{
        "name": "serve_bench", "scenario": "continuous_vs_static",
        "device": _device_name(dev),
        "n_requests": n, "max_slots": max_slots, "slot_len": slot_len,
        "static_tokens": static_toks, "continuous_tokens": cont_toks,
        "static_s": t_static, "static_tok_s": tps_static,
        "continuous_s": t_cont, "continuous_tok_s": tps_cont,
        "policy": "overlap" if overlap else "fcfs",
        "speedup": speedup, "decode_steps": cont_steps,
        "tokens_per_step": cont_toks / max(1, cont_steps),
    }]
    print(f"[serve_bench] static  : {tps_static:8.2f} tok/s "
          f"({t_static:.3f} s for {static_toks} tokens)")
    print(f"[serve_bench] contin. : {tps_cont:8.2f} tok/s "
          f"({t_cont:.3f} s, {cont_steps} steps)")
    print(f"[serve_bench] speedup : {speedup:.3f}x")

    chunk = prefill_chunk or (6 if quick else 16)
    lat_slots = 2 if quick else 4
    results.append(run_chunked_latency(params, cfg, chunk=chunk, smoke=quick,
                                       max_slots=lat_slots, seed=seed,
                                       device=dev))
    # pool == expert count: decode misses are exactly the cold set, so
    # the counter identity does not depend on the workload
    spec = OffloadSpec(cache_size=cfg.moe.num_experts, num_speculative=0,
                       expert_bits=3, attn_bits=4)
    off = OffloadEngine(params, cfg, spec, quantized=True, device=dev)
    results.append(run_chunked_latency(params, cfg, chunk=chunk, smoke=quick,
                                       max_slots=lat_slots, offload=off,
                                       seed=seed))
    results.append(run_paged_kv(params, cfg, smoke=quick,
                                max_slots=lat_slots, seed=seed, device=dev))
    print("[serve_bench] not ported: telemetry_overhead (item 7), "
          "prefix_reuse, overload_preempt, chaos (item 5), zoo (item 6)")
    common.emit(results, "serve_bench")
    if quick:
        assert speedup > 0.2, "smoke: continuous path unreasonably slow"
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", "--smoke", action="store_true",
                    help="tiny workload (seconds)")
    ap.add_argument("--trained", action="store_true",
                    help="the trained tiny-moe instead of random weights")
    ap.add_argument("--n-requests", type=int, default=None)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--slot-len", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overlap", action="store_true",
                    help="the expert-overlap admission policy")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    run(quick=args.quick, trained=args.trained, n_requests=args.n_requests,
        max_slots=args.max_slots, slot_len=args.slot_len, seed=args.seed,
        overlap=args.overlap, prefill_chunk=args.prefill_chunk,
        device=args.device)


if __name__ == "__main__":
    main()
