"""Decode-attention benchmark, dense ring against ragged pages (the port of
the reference's ``benchmarks/attention_bench.py``).

The dense slotted plane pays attention over ``n_slots x slot_len`` every
decode step however much context is live; the paged plane reads only the
live pages.  Two parts:

* ``decode_scaling`` rows: one batched decode-step attention at a fixed
  slot width, the batch's live context swept from 1/8 of the slot to
  full (the reference's shapes, head_dim 64 also at the smoke size so
  that the card's tensor-core route runs).  Dense:
  ``layers.attention_core`` over the ring (the dense-ring decode's
  attention, plain PyTorch).  Ragged: ``ops.ragged_attention``
  over the page work list, which on the card launches the ``ragged_mma``
  kernel (bfloat16, head_dim 64, pages of 32) and counts the launch.  On
  the CPU both are plain f32 and the ragged result equals the dense one
  bitwise at full table width (the reference's parity); on the card the
  kernel is held, row by row, to the plain version in f32 on the same
  bf16 inputs within 2^-7 of the row's largest value.
* ``worklist`` rows: the work list's length (pages visited) for mixed
  per-row lengths, with and without a sliding window, against the dense
  grid: O(total live pages), not O(batch x table width).

Times come from CUDA events around many launches on the card, from the
host clock on the CPU; every row names its device.  Results go to
``experiments/torch/bench/attention_bench.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.attention_bench [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.kernels import ops
from repro_torch.kernels import ragged_attention as RA
from repro_torch.models.layers import attention_core

RAGGED_RTOL = 2 ** -7  # of each row's max |plain|: bf16 kernel vs f32 plain


def _bucket(n: int) -> int:
    w = 1
    while w < n:
        w *= 2
    return w


def _make_layouts(rng, lens, W, ps, Hkv, hd):
    """A dense ring and a paged pool carrying the same live KV entries
    (numpy, f32): ``(kd, vd, posd), (kp, vp, ppos, pages)``."""
    B = len(lens)
    T = W // ps
    kd = np.zeros((B, W, Hkv, hd), np.float32)
    vd = np.zeros((B, W, Hkv, hd), np.float32)
    posd = np.full((B, W), -1, np.int32)
    kp = np.zeros((B * T, ps, Hkv, hd), np.float32)
    vp = np.zeros((B * T, ps, Hkv, hd), np.float32)
    ppos = np.full((B * T, ps), -1, np.int32)
    pages = np.full((B, T), -1, np.int32)
    nxt = 0
    for b, n in enumerate(lens):
        n = int(n)
        for o in range(-(-n // ps)):
            pages[b, o] = nxt
            nxt += 1
        k = rng.standard_normal((n, Hkv, hd)).astype(np.float32)
        v = rng.standard_normal((n, Hkv, hd)).astype(np.float32)
        kd[b, :n], vd[b, :n], posd[b, :n] = k, v, np.arange(n)
        for p in range(n):
            pid = pages[b, p // ps]
            kp[pid, p % ps], vp[pid, p % ps] = k[p], v[p]
            ppos[pid, p % ps] = p
    return (kd, vd, posd), (kp, vp, ppos, pages)


def _timer(dev, iters):
    """ms per call of ``fn``: CUDA events around ``iters`` launches after a
    warm-up on the card, the host clock on the CPU.  On the card a spin
    kernel ahead of the start event holds the device while the host
    queues the launches, so their host cost stays out of the interval."""
    def run(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)  # ~10 ms of device clock cycles
            e0.record()
            for _ in range(iters):
                fn()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    return run


def run(smoke=False, seed=0, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if smoke:
        B, W, ps, Hkv, G, hd, iters = 2, 128, 16, 2, 2, 64, 5
    else:
        B, W, ps, Hkv, G, hd, iters = 4, 512, 32, 4, 2, 64, 30
    H = Hkv * G
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    timed = _timer(dev, iters)
    where = torch.cuda.get_device_name(dev) if cuda else "cpu"

    def on(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt)

    results = []
    launches = 0
    print(f"[attention_bench] decode-step attention, {B} slots x slot_len "
          f"{W} (page {ps}, {H} heads over {Hkv}, head_dim {hd}, {dtype}) "
          f"on {where}:")
    for frac in (0.125, 0.25, 0.5, 1.0):
        lens = np.full((B,), max(1, int(W * frac)), np.int64)
        (kd, vd, posd), (kp, vp, ppos, pages) = _make_layouts(
            rng, lens, W, ps, Hkv, hd)
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        qpos = lens[:, None].astype(np.int32)  # the next position
        width = min(_bucket(-(-int(lens.max()) // ps)), W // ps)
        qd, kdd, vdd = on(q), on(kd), on(vd)
        posd_d, qpos_d = on(posd, torch.int32), on(qpos, torch.int32)
        kpd, vpd, pposd = on(kp), on(vp), on(ppos, torch.int32)
        pages_w = pages[:, :width]
        tables = {w: torch.as_tensor(pages[:, :w]) for w in (width, W // ps)}
        work = None
        if cuda:
            buf, n_seg = RA.pack_worklist(*RA.build_page_worklist(
                pages_w, lens, lens, lens, ps), B)
            work = RA.DeviceWorklist(torch.as_tensor(buf, device=dev), n_seg)

        def dense():
            return attention_core(qd, kdd, vdd, qpos_d, posd_d, causal=True,
                                  window=None)

        def ragged(w=width):
            return ops.ragged_attention(qd, kpd, vpd, pposd, tables[w],
                                        qpos_d, worklist=work)

        before = ops.ragged_attention.launches
        t_dense, t_ragged = timed(dense), timed(ragged)
        n_launch = ops.ragged_attention.launches - before
        launches += n_launch
        row = {"name": "attention_bench", "scenario": "decode_scaling",
               "device": where, "dtype": str(dtype).replace("torch.", ""),
               "slots": B, "slot_len": W, "page": ps, "live_frac": frac,
               "live_tokens": int(lens.sum()), "table_width_pages": width,
               "dense_ms": t_dense, "ragged_ms": t_ragged,
               "speedup": t_dense / max(1e-9, t_ragged),
               "ragged_launches": n_launch}
        if cuda:
            # the kernel against the plain version in f32 on the same
            # bf16 inputs, row by row
            plain = RA.ragged_attention_reference(
                qd.float(), kpd.float(), vpd.float(), pposd,
                torch.as_tensor(pages_w, device=dev), qpos_d)
            got = ragged().float()
            err = (got - plain).abs().amax(dim=(1, 2, 3))
            scale = plain.abs().amax(dim=(1, 2, 3)).clamp_min(1e-30)
            row["max_abs_err"] = float((got - plain).abs().max())
            assert bool((err <= RAGGED_RTOL * scale).all()), \
                f"ragged kernel off its plain version: {err} vs {scale}"
        else:
            assert torch.equal(dense(), ragged(W // ps)), \
                "paged attention diverged from the dense ring"
            row["bitwise_parity_full_width"] = True
        results.append(row)
        print(f"  live {frac:5.3f} ({int(lens[0]):4d} tok/row): dense "
              f"{t_dense:8.4f} ms  ragged {t_ragged:8.4f} ms "
              f"({row['speedup']:.2f}x, width {width}p)")

    # the work list: mixed lengths, with and without a window
    lens = rng.integers(1, W, B).astype(np.int64)
    _, (_, _, _, pages) = _make_layouts(rng, lens, W, ps, Hkv, hd)
    q_lo = q_hi = (lens - 1).astype(np.int32)
    for win in (None, max(ps, W // 8)):
        _, _, wflags = RA.build_page_worklist(pages, lens, q_lo, q_hi, ps,
                                              window=win)
        n_live = int(wflags[:, 2].sum())
        assert n_live <= sum(-(-int(n) // ps) for n in lens)
        results.append({"name": "attention_bench", "scenario": "worklist",
                        "window": win, "live_tokens": int(lens.sum()),
                        "live_pages": n_live,
                        "dense_grid_pages": B * (W // ps)})
        print(f"[attention_bench] work list (window={win}): {n_live} pages "
              f"visited vs {B * (W // ps)} dense ({int(lens.sum())} live "
              f"tokens)")
    common.emit(results, "attention_bench")
    print(f"[attention_bench] wrote {common.BENCH_OUT / 'attention_bench.json'}"
          f" ({len(results)} rows; {launches} ragged kernel launches)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes (seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
