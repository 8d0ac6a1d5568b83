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

Workload 5 (prefix reuse): requests sharing a long system prompt,
served one at a time through one slot, with and without the prefix
cache: time to first token of the requests after the first (a hit
prefills only its tail), equal tokens, at least 2x (1.5x at the quick
size).

Workload 6 (overload): a pool that holds one request's worst case.
Stalling admission runs the requests one at a time; preemption admits on
the prompt's pages and swaps a victim to the host pool when the pool runs
dry.  Tokens/s of both, equal tokens, at least one preemption.

Workload 7 (telemetry overhead): the latency workload with telemetry off
and fully on (timing, tracing, the roofline) on two engines whose steps
interleave, the ratio of their summed step times: equal tokens, and on
the card the instrumented engine keeps >= 0.95x (the reference's floor;
on the CPU the ratio is recorded, not asserted).

Workload 8 (chaos): packed serving on pages under a seeded fault schedule
(5 % transient expert-fetch failures, one NaN row) with cancelling
clients, against the same traffic fault-free: no hang, an empty pool at
teardown, goodput at least 0.7x.

Workload 9 (zoo): recurrent decode (reduced ``xlstm-1.3b``) at two
prompt lengths through the same continuous engine: the decode step's
wall time stays flat in context (on the card < 2x), and so does the cost
model's prediction.

Workloads 5, 6 and 8 have a module-level drive function (what the
card's smoke script and the CPU tests call) beside the ``run_*`` that
times it; 5, 7, 8 and 9 apply the reference's wall-clock floor in a
``check_*`` function (on the card).
"""
from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.configs.base import OffloadSpec
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.serving.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serving.faults import FaultInjector
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
# workload 5: prefix reuse, time to first token of a shared system prompt
def prefix_reuse_workload(cfg, smoke=False, seed=0):
    """Requests sharing a long system prompt, with their own tails: the
    reference's sizes.  Returns (prompts, page, system pages, max_new)."""
    page = 8 if smoke else 16
    sys_pages = 6 if smoke else 10
    tails = (4, 6, 5) if smoke else (8, 12, 10, 14, 9)
    max_new = 4 if smoke else 8
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, cfg.vocab_size, page * sys_pages).astype(np.int32)
    prompts = [np.concatenate(
        [sys_p, rng.integers(1, cfg.vocab_size, t).astype(np.int32)])
        for t in tails]
    return prompts, page, sys_pages, max_new


def drive_prefix_reuse(params, cfg, prompts, *, page, sys_pages, max_new,
                       cache_pages, offload=None, device=None):
    """Serve ``prompts`` one at a time through one slot (each after the
    first can hit what the earlier ones published), prefill chunks of one
    page, with a prefix cache of ``cache_pages`` pages (0: none).  Returns
    (time to first token of each request in ms, tokens, engine)."""
    sys_len = page * sys_pages
    eng = ContinuousEngine(
        None if offload is not None else params, cfg, max_slots=1,
        slot_len=sys_len + 4 * page, eos_id=None, kv_page=page,
        kv_pages_total=2 * sys_pages + 8,  # the cached chain + a worst case
        prefill_chunk=page, prefix_cache_pages=cache_pages, offload=offload,
        device=device)
    ttfts_ms, toks = [], []
    for p in prompts:
        req = eng.submit(p, max_new)
        t0 = time.perf_counter()
        while not req.generated:
            eng.step()
            assert eng.step_count < 100_000
        ttfts_ms.append((time.perf_counter() - t0) * 1e3)
        eng.run(max_steps=100_000)
        assert req.state == "finished"
        toks.append(req.generated)
    return ttfts_ms, toks, eng


def run_prefix_reuse(params, cfg, *, smoke=False, seed=0, offload=None,
                     device=None):
    """Time to first token of the requests after the first, with the
    prefix cache against without, best of alternating passes after a
    warm-up: equal greedy tokens, and every follow-up skips its shared
    prefill.  The floor (:func:`check_prefix_reuse`) is the reference's."""
    dev = resolve_device(device) if offload is None else offload.device
    prompts, page, sys_pages, max_new = prefix_reuse_workload(cfg, smoke,
                                                              seed)
    cache_pages = sys_pages + 2

    def drive(n):
        return drive_prefix_reuse(params, cfg, prompts, page=page,
                                  sys_pages=sys_pages, max_new=max_new,
                                  cache_pages=n, offload=offload, device=dev)

    drive(0)  # warm-up
    drive(cache_pages)
    best = {"cold": np.inf, "hit": np.inf}
    for _ in range(2 if smoke else 3):
        cold_t, cold_toks, _ = drive(0)
        hit_t, hit_toks, eng = drive(cache_pages)
        assert hit_toks == cold_toks, "prefix cache changed tokens"
        best["cold"] = min(best["cold"], float(np.median(cold_t[1:])))
        best["hit"] = min(best["hit"], float(np.median(hit_t[1:])))
    assert eng._prefills_skipped == len(prompts) - 1, \
        "every follow-up request should hit the cached system prompt"
    row = {
        "name": "serve_bench", "scenario": "prefix_reuse",
        "device": _device_name(dev),
        "kv_page": page, "sys_len": page * sys_pages,
        "n_requests": len(prompts), "prefix_cache_pages": cache_pages,
        "cold_ttft_ms": best["cold"], "hit_ttft_ms": best["hit"],
        "ttft_speedup": best["cold"] / max(1e-9, best["hit"]),
        "prefills_skipped": int(eng._prefills_skipped),
        "hit_tokens": int(eng._prefix_hit_tokens),
        "token_parity": True,
    }
    print(f"[serve_bench] prefix reuse (sys {row['sys_len']}, page {page}): "
          f"TTFT cold {row['cold_ttft_ms']:.2f} ms -> hit "
          f"{row['hit_ttft_ms']:.2f} ms ({row['ttft_speedup']:.2f}x, "
          f"{row['hit_tokens']} prompt tokens not prefilled again)")
    check_prefix_reuse(row, smoke)
    return row


def check_prefix_reuse(row, smoke=False):
    floor = 1.5 if smoke else 2.0
    assert row["ttft_speedup"] >= floor, \
        f"prefix-hit TTFT speedup {row['ttft_speedup']:.2f}x below {floor}x"


# ----------------------------------------------------------------------
# workload 6: overload, optimistic admission + preemption against stalls
def overload_workload(cfg, smoke=False, seed=0):
    """The reference's starved pool: every request's worst case is the
    whole pool.  Returns (prompts, max_new, page, max_slots, pages)."""
    page, max_slots, plen = 4, 4, 3
    n_req = 5 if smoke else 8
    max_new = 10 if smoke else 28
    pages_total = (plen + max_new + page - 1) // page + 1  # one worst case
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
               for _ in range(n_req)]
    return prompts, max_new, page, max_slots, pages_total


def drive_overload(params, cfg, prompts, news, *, page, max_slots,
                   pages_total, slot_len, host_pages=None, offload=None,
                   device=None):
    """Serve ``prompts`` (priorities ``i % 2``) over a pool of
    ``pages_total`` pages: stalling admission at the worst case
    (``host_pages`` None), or preemption with a host pool of
    ``host_pages`` pages (0: every resume recomputes).  Returns (tokens,
    tokens/s, engine)."""
    dev = resolve_device(device) if offload is None else offload.device
    kw = ({} if host_pages is None
          else dict(preemption=True, kv_host_pages=host_pages))
    eng = ContinuousEngine(None if offload is not None else params, cfg,
                           max_slots=max_slots, slot_len=slot_len,
                           eos_id=None, kv_page=page,
                           kv_pages_total=pages_total, offload=offload,
                           device=dev, **kw)
    reqs = [eng.submit(p, m, priority=i % 2)
            for i, (p, m) in enumerate(zip(prompts, news))]
    t0 = time.perf_counter()
    eng.run(max_steps=100_000)
    _sync(dev)
    wall = time.perf_counter() - t0
    assert all(r.state == "finished" for r in reqs)
    toks = [r.generated for r in reqs]
    return toks, sum(len(t) for t in toks) / wall, eng


def run_overload_preempt(params, cfg, *, smoke=False, seed=0, device=None):
    """A pool so starved that stalling admission runs the requests one at
    a time; preemption admits on prompt-size reservations, grows page by
    page and swaps a victim to the host pool when the pool runs dry.
    Tokens/s of both, best of alternating passes after a warm-up; tokens
    must be equal and preemption must have happened."""
    dev = resolve_device(device)
    prompts, max_new, page, max_slots, pages_total = overload_workload(
        cfg, smoke, seed)
    host_pages = 2 * pages_total
    news = [max_new] * len(prompts)

    def drive(host):
        return drive_overload(params, cfg, prompts, news, page=page,
                              max_slots=max_slots, pages_total=pages_total,
                              slot_len=3 + max_new + page, host_pages=host,
                              device=dev)

    drive(None)  # warm-up
    drive(host_pages)
    best = {"stall": 0.0, "preempt": 0.0}
    for _ in range(2 if smoke else 3):
        base_toks, tps, _ = drive(None)
        best["stall"] = max(best["stall"], tps)
        toks, tps, eng = drive(host_pages)
        best["preempt"] = max(best["preempt"], tps)
        assert toks == base_toks, "preemption changed generated tokens"
    assert eng.sched.preemptions > 0, \
        "overload workload never triggered a preemption"
    hs = eng.kv.host_stats()
    row = {
        "name": "serve_bench", "scenario": "overload_preempt",
        "device": _device_name(dev),
        "kv_page": page, "kv_pages_total": pages_total,
        "kv_host_pages": host_pages, "n_requests": len(prompts),
        "max_new": max_new,
        "stall_tok_s": best["stall"], "preempt_tok_s": best["preempt"],
        "tok_s_speedup": best["preempt"] / max(1e-9, best["stall"]),
        "preemptions": int(eng.sched.preemptions),
        "resumes": int(eng.sched.resumes),
        "recomputes": int(eng._recomputes),
        "swap_out_bytes": int(hs["swap_out_bytes"]),
        "token_parity": True,
    }
    print(f"[serve_bench] overload ({len(prompts)} requests, {pages_total}-"
          f"page pool): stall {row['stall_tok_s']:.2f} tok/s -> preempt "
          f"{row['preempt_tok_s']:.2f} tok/s ({row['tok_s_speedup']:.2f}x, "
          f"{row['preemptions']} preemptions, {row['swap_out_bytes']} bytes "
          f"swapped)")
    return row


# ----------------------------------------------------------------------
# workload 7: telemetry overhead, the telemetry plane's hot-path contract
def _interleaved_pass(make_engine, workload, on_first: bool):
    """One pass of ``workload`` on an engine without telemetry and one with
    it, their steps interleaved (the one that steps first alternating,
    starting with the instrumented one when ``on_first``), every step
    timed.  The two engines plan the same steps (the same traffic, greedy,
    the same schedule), so step k of each does the same work, back to
    back.  Executors may be shared (the packed plane); each engine passes
    its own observer to its decode calls.  Returns ({on: step seconds},
    {on: tokens per request}, the instrumented engine)."""
    engs = {False: make_engine(False), True: make_engine(True)}
    reqs = {on: [e.submit(p, m) for p, m in workload] for on, e in engs.items()}
    times = {False: [], True: []}
    order = (True, False) if on_first else (False, True)
    busy = lambda e: e.sched.has_waiting or e.sched.n_running
    while busy(engs[False]) or busy(engs[True]):
        for on in order:
            e = engs[on]
            t0 = time.perf_counter()
            e.step()
            times[on].append(time.perf_counter() - t0)
        order = order[::-1]
        assert len(times[True]) < 100_000
    assert busy(engs[False]) == busy(engs[True]), "the two engines diverged"
    toks = {on: [r.generated for r in rs] for on, rs in reqs.items()}
    return times, toks, engs[True]


def run_telemetry_overhead(params, cfg, *, smoke=False, max_slots=4, seed=0,
                           offload=None, workload=None, kv_page=None,
                           device=None):
    """Telemetry off against fully on (timing, tracing, the roofline) over
    the same traffic (the latency workload unless ``workload`` is given),
    on the plain plane or, with ``offload``, the packed one, on dense
    slots or on pages of ``kv_page``.  After a warm-up pass, 5 passes
    that interleave the two engines' steps (:func:`_interleaved_pass`).
    ``overhead_ratio`` is the whole-window ratio: the summed step times
    of the uninstrumented engine over the instrumented one's, over all 5
    passes (= on tok/s over off tok/s), so a cost that falls on a few
    steps (a roofline window's close, the trace buffer's growth) counts
    in full.  The reference alternates whole passes and takes the ratio
    of the best of 2 / 3; on the card a quick-size pass lasts ~0.2 s and
    its admission steps' times drift by tens of percent from pass to
    pass, which interleaving the two engines' steps removes.  The median
    of the per-step ratios is reported beside it as a per-step statistic
    only.  Asserts equal tokens; on the card the floor is
    :func:`check_telemetry_overhead`, on the CPU the ratio is recorded,
    not asserted (host noise).  Returns the row."""
    dev = resolve_device(device) if offload is None else offload.device
    workload = workload or make_latency_workload(cfg, max_slots, smoke=smoke,
                                                 seed=seed)
    slot_len = max(48 if smoke else 128,
                   max(len(p) + m for p, m in workload))

    def make_engine(on):
        return ContinuousEngine(
            None if offload is not None else params, cfg,
            max_slots=max_slots, slot_len=slot_len, eos_id=None,
            offload=offload, kv_page=kv_page, device=dev,
            telemetry=Telemetry(timing=True, trace=True) if on else None)

    _interleaved_pass(make_engine, workload, False)  # warm-up
    times = {False: [], True: []}
    for i in range(5):
        gc.collect()
        t, toks, eng = _interleaved_pass(make_engine, workload, i % 2 == 1)
        assert toks[True] == toks[False], "telemetry changed generated tokens"
        for on in t:
            times[on] += t[on]
    off, on = np.asarray(times[False]), np.asarray(times[True])
    ratio = float(off.sum() / on.sum())
    n_tok = 5 * sum(len(t) for t in toks[True])
    snap = eng.metrics()  # the last instrumented engine's registry
    row = {
        "name": "serve_bench", "scenario": "telemetry_overhead",
        "device": _device_name(dev),
        "plane": "packed" if offload is not None else "plain",
        "max_slots": max_slots, "slot_len": slot_len, "steps": len(on),
        "off_tok_s": n_tok / off.sum(), "on_tok_s": n_tok / on.sum(),
        "overhead_ratio": ratio,
        "median_step_ratio": float(np.median(off / on)),
        "step_wall_p50_ms": snap["step"]["wall_ms"]["p50"],
        "trace_events": len(eng.obs.tracer.events),
        "roofline": {k: snap["roofline"][k] for k in (
            "measured_tok_s", "predicted_tok_s", "delta_ratio",
            "h2d_savings_ratio")},
        "token_parity": True,
    }
    print(f"[serve_bench] telemetry overhead: off {row['off_tok_s']:.1f} "
          f"tok/s -> on {row['on_tok_s']:.1f} tok/s; overhead ratio "
          f"{ratio:.3f}x over {len(on)} interleaved step pairs (median step "
          f"ratio {row['median_step_ratio']:.3f}x; tracing on)")
    if dev.type == "cuda":
        check_telemetry_overhead(row)
    return row


def check_telemetry_overhead(row):
    assert row["overhead_ratio"] >= 0.95, \
        f"telemetry overhead exceeds 5%: {row['overhead_ratio']:.3f}x of " \
        f"the uninstrumented tokens/s"


# ----------------------------------------------------------------------
# workload 8: chaos goodput, seeded faults against the fault-free run
CHAOS_SCHEDULE = "expert_fetch=0.05,nan_logits@3"


def chaos_workload(cfg, smoke=False, seed=0):
    """The reference's chaos traffic: (prompt, max_new) pairs and the
    cancel stride (every stride-th client leaves after its first token)."""
    n_req = 8 if smoke else 16
    rng = np.random.default_rng(seed)
    lengths = (4, 8) if smoke else (8, 16)
    news = (4, 10) if smoke else (8, 24)
    workload = [(rng.integers(1, cfg.vocab_size, int(rng.choice(lengths))
                              ).astype(np.int32), int(rng.integers(*news)))
                for _ in range(n_req)]
    return workload, 4 if smoke else 6


def drive_chaos(cfg, off, workload, *, inject, cancel_stride, page=8,
                max_slots=3, slot_len=64, seed=0, on_engine=None):
    """Packed continuous serving on pages with the invariant audit on
    every step, under ``CHAOS_SCHEDULE`` and the cancelling clients
    (``inject``) or fault-free.  Each drive replays the schedule from a
    fresh injector.  Asserts no hang and an empty pool at teardown.
    ``on_engine`` is called with the engine before it serves (a tracer).
    Returns (delivered tokens/s, engine, requests)."""
    faults = (FaultInjector.parse(CHAOS_SCHEDULE, seed=seed)
              if inject else None)
    eng = ContinuousEngine(None, cfg, max_slots=max_slots, slot_len=slot_len,
                           eos_id=None, offload=off, kv_page=page,
                           faults=faults, check_invariants=True)
    if on_engine is not None:
        on_engine(eng)
    reqs = [eng.submit(p, m) for p, m in workload]
    victims = ([r for i, r in enumerate(reqs)
                if i % cancel_stride == cancel_stride - 1] if inject else [])
    t0 = time.perf_counter()
    while eng.sched.has_waiting or eng.sched.n_running or eng._swapped:
        eng.step()
        for r in list(victims):  # a client leaves once it saw a token
            if r.generated and r.state != "finished":
                assert eng.cancel(r.rid)
                victims.remove(r)
        assert eng.step_count < 100_000
    _sync(off.device)
    wall = time.perf_counter() - t0
    assert all(r.state == "finished" for r in reqs), "engine hung"
    eng.check_invariants()
    pool = eng.kv.pool
    assert pool.n_free == pool.n_pages and pool.refs == {}, \
        "chaos run leaked pages at teardown"
    # goodput: the tokens delivered (a cancelled client got its prefix)
    return sum(len(r.generated) for r in reqs) / wall, eng, reqs


def run_chaos(params, cfg, off, *, smoke=False, seed=0):
    """Goodput under the seeded fault schedule and cancelling clients
    against the same traffic fault-free (best of alternating passes after
    a warm-up).  The engine must not hang, the pool must be empty at
    teardown, the schedule must have hit a fetch boundary, one request
    must have been quarantined and the cancels counted; the floor
    (:func:`check_chaos`) is the reference's."""
    workload, stride = chaos_workload(cfg, smoke, seed)

    def drive(inject):
        return drive_chaos(cfg, off, workload, inject=inject,
                           cancel_stride=stride, seed=seed)

    drive(False)  # warm-up
    drive(True)
    best = {"clean": 0.0, "chaos": 0.0}
    for _ in range(2 if smoke else 3):
        best["clean"] = max(best["clean"], drive(False)[0])
        tps, eng, _ = drive(True)
        best["chaos"] = max(best["chaos"], tps)
    s = eng.stats()
    assert s["faults_fired_expert_fetch"] > 0, \
        "fault schedule never hit a fetch boundary"
    assert s["faults_failed"] == 1, \
        "NaN poisoning should quarantine exactly one request"
    assert s["faults_cancelled"] == len(workload) // stride
    row = {
        "name": "serve_bench", "scenario": "chaos_goodput",
        "device": _device_name(off.device),
        "n_requests": len(workload), "max_slots": 3, "kv_page": 8,
        "fault_schedule": CHAOS_SCHEDULE,
        "clean_tok_s": best["clean"], "chaos_tok_s": best["chaos"],
        "goodput_ratio": best["chaos"] / max(1e-9, best["clean"]),
        "fired_expert_fetch": int(s["faults_fired_expert_fetch"]),
        "fetch_retries": int(s["faults_fetch_retries"]),
        "fetch_degraded": int(s["faults_fetch_degraded"]),
        "completed": int(s["faults_completed"]),
        "cancelled": int(s["faults_cancelled"]),
        "failed": int(s["faults_failed"]),
        "pages_leaked": 0,
        "no_crash": True,
    }
    print(f"[serve_bench] chaos ({CHAOS_SCHEDULE}): clean "
          f"{row['clean_tok_s']:.2f} tok/s -> chaos {row['chaos_tok_s']:.2f} "
          f"tok/s ({row['goodput_ratio']:.2f}x goodput, "
          f"{row['fetch_retries']} retries, {row['fetch_degraded']} "
          f"degraded, {row['cancelled']} cancelled, 0 pages leaked)")
    check_chaos(row)
    return row


def check_chaos(row):
    assert row["goodput_ratio"] >= 0.7, \
        f"chaos goodput {row['goodput_ratio']:.2f}x below the 0.7x floor"


# ----------------------------------------------------------------------
# workload 9: recurrent decode of the config zoo, flat in context
def run_zoo(*, smoke=False, seed=0, device=None):
    """Recurrent decode (reduced ``xlstm-1.3b``) through the same
    ``ContinuousEngine`` the attention stacks use, at two prompt lengths:
    the recurrent state is O(1) per slot, so a decode step's wall time
    must not grow with the context before it (the measured counterpart of
    the cost model's flat ``recurrent_state_bytes`` term), where an
    attention stack pays a KV read that grows with it.  Median decode-step
    ms, best of 2 passes per context, the contexts in turns after a
    warm-up of both; the cost
    model's prediction on the ``h100`` row must be flat too.  The
    wall-clock floor (:func:`check_zoo`) is applied on the card only."""
    from repro_torch.core.cost_model import (HARDWARE, TokenStats,
                                             tokens_per_second)
    dev = resolve_device(device)
    cfg = get_config("xlstm-1.3b").reduced()
    params = T.init_model(cfg, seed=1, device=dev)
    rng = np.random.default_rng(seed)
    short_ctx, long_ctx = (8, 64) if smoke else (8, 256)
    max_new = 12 if smoke else 32

    def decode_samples(ctx_len):
        """Decode-step wall ms at one prompt length (chunked prefill at a
        shared chunk size; only the steps that emit a decode token)."""
        eng = ContinuousEngine(params, cfg, max_slots=1,
                               slot_len=ctx_len + max_new + 8, eos_id=None,
                               prefill_chunk=8, device=dev)
        prompt = rng.integers(1, cfg.vocab_size, ctx_len).astype(np.int32)
        req = eng.submit(prompt, max_new)
        samples = []
        while eng.sched.has_waiting or eng.sched.n_running:
            before = len(req.generated)
            t0 = time.perf_counter()
            eng.step()
            dt_ms = (time.perf_counter() - t0) * 1e3
            if len(req.generated) > before and before > 0:
                samples.append(dt_ms)
            assert eng.step_count < 100_000
        return samples

    for ctx in (short_ctx, long_ctx):  # warm-up
        decode_samples(ctx)
    ms = {short_ctx: np.inf, long_ctx: np.inf}
    for _ in range(2):  # the contexts in turns: host drift hits both
        for ctx in ms:
            ms[ctx] = min(ms[ctx], float(np.median(decode_samples(ctx))))
    ratio = ms[long_ctx] / max(1e-9, ms[short_ctx])
    stats = TokenStats(0.0, 0.0, 0.0, 0.0)
    pred = [tokens_per_second(cfg, HARDWARE["h100"], stats, expert_bits=16,
                              attn_bits=16, context_len=c)
            for c in (short_ctx, long_ctx)]
    assert pred[0] == pred[1], "cost model: recurrent tok/s must be flat"
    row = {
        "name": "serve_bench", "scenario": "zoo", "arch": cfg.name,
        "device": _device_name(dev),
        "short_ctx": short_ctx, "long_ctx": long_ctx, "max_new": max_new,
        "short_ctx_decode_ms": ms[short_ctx],
        "long_ctx_decode_ms": ms[long_ctx],
        "short_ctx_tok_s": 1e3 / ms[short_ctx],
        "long_ctx_tok_s": 1e3 / ms[long_ctx],
        "context_cost_ratio": ratio,
        "predicted_tok_s_flat": pred[0],
    }
    print(f"[serve_bench] zoo ({cfg.name}): decode "
          f"{row['short_ctx_tok_s']:.1f} tok/s @ctx{short_ctx} vs "
          f"{row['long_ctx_tok_s']:.1f} tok/s @ctx{long_ctx} ({ratio:.2f}x; "
          f"predicted {pred[0]:.1f} tok/s at both)")
    if dev.type == "cuda":
        check_zoo(row)
    return row


def check_zoo(row):
    assert row["context_cost_ratio"] < 2.0, \
        f"recurrent decode cost grew with context: " \
        f"{row['short_ctx_decode_ms']:.3f} -> " \
        f"{row['long_ctx_decode_ms']:.3f} ms ({row['context_cost_ratio']:.2f}x)"


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
    results.append(run_prefix_reuse(params, cfg, smoke=quick, seed=seed,
                                    device=dev))
    results.append(run_overload_preempt(params, cfg, smoke=quick, seed=seed,
                                        device=dev))
    results.append(run_telemetry_overhead(params, cfg, smoke=quick,
                                          max_slots=lat_slots, seed=seed,
                                          device=dev))
    results.append(run_chaos(params, cfg, off, smoke=quick, seed=seed))
    results.append(run_zoo(smoke=quick, seed=seed, device=dev))
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
