"""Packed offloaded decode on the paper's three data planes (the port of
the reference's ``benchmarks/offload_bench.py``):

* ``pr2_sync``: per-(token, k) slot swaps and three 2-D dequant-matmul
  launches per (token, k) pair, staging after the compute
  (``pipelined=False, vectorized=False``);
* ``vectorized``: batched slot plans and one slot-binding launch per
  matrix, staging still after the compute (``pipelined=False``);
* ``pipelined``: the default engine, staging issued on the copy stream
  before the compute.

The three decode one prompt over one HQQ-packed store; each must give
the tokens of ``generate_plain`` over the dequantized weights, and all
three the same counters (the plane changes how bytes move, never how
many).  Reported per plane: the first generate's seconds, then on a
second run prefill seconds, decode tokens/s with p50/p95 ms per token
(host clock at each token, which is read back), h2d bytes per token
issued and counted, hit ratio, and the kernel launches by binding and
route (all 0 on the CPU, where the plain versions run).

``--speculative`` adds the reference's draft-and-verify scenario: the
pipelined plane at a cache of 6 of 8 experts, greedy decode without a
draft, then a ``ReplayDraft`` of that stream (acceptance 1.0) at k = 4;
the tokens must equal the baseline's and the h2d bytes must not exceed
its.  Rows ``spec_baseline``, ``speculative`` and ``spec_summary``; the
measured ratio of decode rates is printed beside the device's name and
held to no bar.

The router top-k ablation (the serving CLI's ``--top-k-override``):
the pipelined plane with every token routed to one expert instead of the
arch's top-k, its h2d bytes per token beside the pipelined row's (row
``top_k_override``).  The reference asserts that k = 1 moves fewer
bytes; the port records the ratio instead, for it depends on the
weights: the speculative staging of ``num_speculative`` predicted
experts per layer does not shrink with k, and on the port's random
seed-0 ``tiny-moe`` it outweighs the halved demand loads (k = 1 moves
more bytes), while on the reference's seed-0 weights it does not; on the
same weights both packages give the same counters.

Results go to ``experiments/torch/bench/offload_bench.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.offload_bench [--smoke] [--trained] [--speculative]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.core.draft import ReplayDraft
from repro_torch.core.offload_engine import (OffloadEngine, generate_plain,
                                             quantize_for_offload)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

VARIANTS = {
    "pr2_sync": dict(pipelined=False, vectorized=False),
    "vectorized": dict(pipelined=False, vectorized=True),
    "pipelined": dict(pipelined=True, vectorized=True),
}


def _counts():
    return {**ops.launches(), **ops.routes()}


def run(smoke=False, trained=False, max_new=None, seed=0, device=None,
        speculative=False):
    dev = resolve_device(device)
    if trained:
        params, cfg = common.get_trained_tiny_moe(device=dev)
    else:
        cfg = get_config("tiny-moe")
        params = T.init_model(cfg, seed=seed, device=dev)
    spec = cfg.offload
    max_new = max_new or (8 if smoke else 48)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, cfg.vocab_size, (1, 12)).astype(np.int32)

    qdeq, _ = quantize_for_offload(params, cfg, spec, device=dev)
    oracle = generate_plain(qdeq, cfg, prompt, max_new, device=dev)

    results = []
    traffic = {}
    for name, kw in VARIANTS.items():
        eng = OffloadEngine(params, cfg, spec, quantized=True, device=dev,
                            **kw)
        t0 = time.perf_counter()
        out, _ = eng.generate(prompt, max_new)
        first_gen_s = time.perf_counter() - t0
        assert (out == oracle).all(), f"{name}: diverged from generate_plain"
        stamps = []
        before = _counts()
        out, stats = eng.generate(
            prompt, max_new,
            on_step=lambda lg, r: stamps.append(time.perf_counter()))
        counts = {k: v - before[k] for k, v in _counts().items()}
        assert (out == oracle).all(), f"{name}: diverged from generate_plain"
        ps, t = eng._last_pool_state, eng.last_timing
        assert ps.h2d_bytes == stats.bytes_h2d, \
            f"{name}: h2d bytes issued {ps.h2d_bytes} != counted {stats.bytes_h2d}"
        traffic[name] = (stats.hits, stats.spec_hits, stats.demand_loads,
                         stats.spec_loads)
        lat_ms = np.diff(stamps) * 1e3
        n = max(1, stats.n_tokens)
        results.append({
            "name": "offload_bench", "variant": name, "max_new": max_new,
            "device": str(dev),
            "first_gen_s": round(first_gen_s, 3),
            "prefill_s": round(t["prefill_s"], 4),
            "decode_ms_per_token": round(t["decode_s"] / t["decode_steps"] * 1e3, 2),
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
            "p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
            "tok_s": round(t["decode_steps"] / t["decode_s"], 2),
            "bytes_per_token": round(stats.bytes_h2d / n, 1),
            "hit_ratio": round(stats.hit_ratio, 4),
            "counters": dict(zip(("hits", "spec_hits", "demand_loads",
                                  "spec_loads"), traffic[name])),
            "launches": {k: v for k, v in counts.items() if v},
            "tokens": out[0].tolist(),
        })
        r = results[-1]
        print(f"[offload_bench] {name:10s}: {r['tok_s']:8.2f} tok/s decode "
              f"({r['decode_ms_per_token']:6.1f} ms/token, p50/p95 "
              f"{r['p50_ms']:.1f}/{r['p95_ms']:.1f}ms, first gen "
              f"{first_gen_s:6.1f}s, {r['bytes_per_token'] / 1e3:.1f}KB/token "
              f"h2d, hit_ratio={stats.hit_ratio:.3f}, launches {r['launches']})")
    assert len(set(traffic.values())) == 1, \
        f"variants disagree on transfer counters: {traffic}"
    base = next(r for r in results if r["variant"] == "pr2_sync")
    pipe = next(r for r in results if r["variant"] == "pipelined")
    speedup = pipe["tok_s"] / base["tok_s"]
    print(f"[offload_bench] decode speedup (pipelined vs pr2_sync): "
          f"{speedup:.2f}x")
    results.append({"name": "offload_bench", "variant": "summary",
                    "speedup": round(speedup, 3)})
    if speculative:
        results += _speculative(params, cfg, spec, prompt, oracle, max_new,
                                dev)
    results.append(_top_k_override(params, cfg, spec, prompt, max_new, dev,
                                   pipe))

    common.emit(results, "offload_bench")
    return results


def _top_k_override(params, cfg, spec, prompt, max_new, dev, pipe):
    """The reference's router top-k ablation: routing every token to one
    expert shrinks the per-token routed working set (module docstring:
    the bytes it saves are recorded, not asserted)."""
    from repro_torch.launch.serve import resolve_top_k
    assert cfg.moe.top_k > 1, "top-k ablation needs a multi-expert router"
    eng = OffloadEngine(params, resolve_top_k(cfg, 1), spec, quantized=True,
                        device=dev)
    out, stats = eng.generate(prompt, max_new)
    bpt = stats.bytes_h2d / max(1, stats.n_tokens)
    base = pipe["bytes_per_token"]
    print(f"[offload_bench] top_k_override: k=1 h2d {bpt / 1e3:.1f}KB/token "
          f"vs k={cfg.moe.top_k} {base / 1e3:.1f}KB/token "
          f"({base / max(1e-9, bpt):.2f}x less traffic)")
    return {"name": "offload_bench", "variant": "top_k_override",
            "device": str(dev), "top_k": 1, "arch_top_k": cfg.moe.top_k,
            "max_new": max_new, "bytes_per_token": round(bpt, 1),
            "baseline_bytes_per_token": base,
            "h2d_savings_ratio": round(base / max(1e-9, bpt), 3),
            "hit_ratio": round(stats.hit_ratio, 4),
            "counters": {"hits": stats.hits, "spec_hits": stats.spec_hits,
                         "demand_loads": stats.demand_loads,
                         "spec_loads": stats.spec_loads},
            "tokens": out[0].tolist()}


def _speculative(params, cfg, spec, prompt, oracle, max_new, dev, k=4):
    """The reference's speculative scenario: pipelined plane, cache 6 of
    8, greedy decode, then a replay draft of that stream (acceptance 1.0)
    at ``k``; each timed on a second run.  The expert and attention bits
    are those of the oracle's weights, so its tokens are the target."""
    eng = OffloadEngine(params, cfg, dataclasses.replace(spec, cache_size=6),
                        quantized=True, device=dev)
    ref = np.concatenate([prompt[0], oracle[0]])

    def timed_gen(**kw):
        for _ in range(2):  # the first run warms up
            out, stats = eng.generate(prompt, max_new, **kw)
            assert (out == oracle).all(), "speculative scenario: diverged"
        t = eng.last_timing
        return t["decode_steps"] / t["decode_s"], stats

    rate_base, s_base = timed_gen()
    rate_spec, s_spec = timed_gen(
        draft=ReplayDraft(ref, vocab_size=cfg.vocab_size), num_draft_tokens=k)
    assert s_spec.bytes_h2d <= s_base.bytes_h2d, \
        f"speculation increased the h2d bytes at acceptance 1.0: " \
        f"{s_spec.bytes_h2d} > {s_base.bytes_h2d}"
    sm = eng.spec_metrics
    rows = []
    for variant, rate, stats, kk in (("spec_baseline", rate_base, s_base, 0),
                                     ("speculative", rate_spec, s_spec, k)):
        rows.append({
            "name": "offload_bench", "variant": variant, "max_new": max_new,
            "num_draft_tokens": kk, "tok_s": round(rate, 2),
            "decode_ms_per_token": round(1e3 / rate, 2),
            "bytes_per_token": round(stats.bytes_h2d / max(1, stats.n_tokens), 1),
            "hit_ratio": round(stats.hit_ratio, 4)})
        print(f"[offload_bench] {variant:13s}: {rate:8.2f} tok/s decode, "
              f"hit_ratio={stats.hit_ratio:.3f}, "
              f"h2d={stats.bytes_h2d / 1e6:.2f}MB")
    where = _device_name(dev)
    ratio = rate_spec / rate_base
    print(f"[offload_bench] speculative / non-speculative decode rate (k={k}, "
          f"acceptance {sm.acceptance_rate:.2f}): {ratio:.2f}x on {where}")
    rows.append({"name": "offload_bench", "variant": "spec_summary",
                 "num_draft_tokens": k, "device_name": where,
                 "acceptance_rate": round(sm.acceptance_rate, 3),
                 "rounds": sm.rounds,
                 "hit_ratio": round(s_base.hit_ratio, 4),
                 "spec_rate_ratio": round(ratio, 3)})
    return rows


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="8 new tokens instead of 48")
    ap.add_argument("--trained", action="store_true",
                    help="use the trained tiny-moe (routing with locality; "
                         "trains and caches it on first use)")
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    ap.add_argument("--speculative", action="store_true",
                    help="add the draft-and-verify scenario (replay draft "
                         "at acceptance 1.0, k = 4, cache 6 of 8)")
    args = ap.parse_args()
    run(smoke=args.smoke, trained=args.trained, max_new=args.max_new,
        seed=args.seed, device=args.device, speculative=args.speculative)


if __name__ == "__main__":
    main()
