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

Results go to ``experiments/torch/bench/offload_bench.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.offload_bench [--smoke] [--trained]

The reference's ``speculative`` scenario (draft-and-verify decoding) is
not ported: ``--speculative`` raises ``NotImplementedError``.  Nor is
its router top-k ablation, which belongs with the serving CLI's
``--top-k-override`` (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.configs import get_config
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
    if speculative:
        raise NotImplementedError(
            "the speculative (draft-and-verify) scenario is not ported yet: "
            "ROADMAP queue 1, item 4")
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

    common.emit(results, "offload_bench")
    return results


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
                    help="the reference's draft-and-verify scenario (not "
                         "ported: raises)")
    args = ap.parse_args()
    run(smoke=args.smoke, trained=args.trained, max_new=args.max_new,
        seed=args.seed, device=args.device, speculative=args.speculative)


if __name__ == "__main__":
    main()
