"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. device: a CUDA device or exit 1; print the card's name and power limit;
   build every kernel from the sources in this checkout (``nvcc``).
2. kernels: each binding of the dequant-matmul kernel against its plain
   PyTorch version on the card at the main path's shapes (2- and 3-bit
   codes), with its time, the plain version's time and the bound.
3. parity: ``tiny-moe`` generated on the card (kernels) and on the CPU
   (plain versions) from the same seeded weights: equal tokens, routing
   and counters, logits within tolerance.
4. main path: ``mixtral-offload`` at full width (depth cut to 8 of 32
   layers), weights from a seeded generator, quantized on the card; a
   64-token prompt prefilled and 32 tokens generated greedily through
   ``OffloadEngine.generate``, with the kernel launch counts, the h2d
   bytes actually issued against the counters, and pool coherence.
5. prefill kernel: the batched binding timed again at the shapes the main
   run's prefill launched (experts x rows padded to the largest group),
   beside the same rows spread evenly, so the padding's cost shows.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores: the
                             # inputs are bf16 activations and integer codes
KERNEL_RTOL = 1e-4           # of max |plain|: f32 sums over <= 14336 terms in another order
LOGIT_ATOL = 1e-3            # tiny-moe f32 logits, card vs CPU
MAIN_LAYERS = 8              # depth cut of mixtral-offload
PROMPT_LEN, NEW_TOKENS = 64, 32


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.compile_source("dequant_matmul")
    regs = sorted({ln.strip() for ln in report.splitlines() if "registers" in ln})
    log(f"[build] dequant_matmul.cu in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(regs))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------------
def _event_ms(fn, n, flush):
    """Mean device time of ``fn``, each launch timed alone after the L2
    cache is overwritten (the main path finds its weights cold).  A spin
    kernel ahead of the start event keeps the host's launch overhead out
    of the interval."""
    import torch
    fn()
    total = 0.0
    for _ in range(n):
        flush.fill_(1)
        torch.cuda._sleep(2_000_000)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def _stored_bytes(qt, n_slots):
    from repro_torch.quant import hqq
    return n_slots * sum(a[0].numel() * a.element_size()
                         for _, a in hqq.leaves(qt))


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the bf16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


SHAPES = ((4096, 14336), (14336, 4096), (4096, 14336))  # gate, down, up


def phase_kernels(dev):
    """Each binding at the main path's shapes: decode (``slots``: B = 2
    rows, M = 1, over a pool of 4 slots) and prefill (``batched``: B = 8
    distinct experts, M = 16 rows each); gate/up (4096 x 14336) and down
    (14336 x 4096); x bf16; 2- and 3-bit codes.  The kernels line reports
    the 2-bit (mixtral-offload) figures summed over one layer's three
    matrices; the batched figures there are replaced by phase 5's, taken
    at the main run's own prefill shapes.  Returns (figures, the 8-expert
    tiers by (bits, K, N), the L2 flush buffer)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import hqq
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    shapes = SHAPES
    cases = {"dequant_matmul_slots": dict(B=2, M=1, S=4),
             "dequant_matmul_batched": dict(B=8, M=16, S=8)}
    acc = {n: dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0, err=0.0, rel=0.0)
           for n in cases}
    tiers = {}
    for bits in (2, 3):
        for K, N in sorted(set(shapes)):
            w = torch.randn((8, K, N), generator=gen, device=dev) * 0.02
            tiers[bits, K, N] = hqq.quantize(w.to(torch.bfloat16), bits)
            del w
    for bits in (2, 3):
        for name, c in cases.items():
            for K, N in shapes:
                qt = tiers[bits, K, N]
                if c["S"] < 8:
                    qt = hqq.QTensor(qt.packed[:c["S"]], qt.scale[:c["S"]],
                                     qt.zero[:c["S"]],
                                     {k: v[:c["S"]] for k, v in qt.meta.items()},
                                     bits, qt.group_size, (c["S"], K, N))
                x = torch.randn((c["B"], c["M"], K), generator=gen,
                                device=dev).to(torch.bfloat16)
                if name == "dequant_matmul_slots":
                    slots = torch.tensor([3, 1], dtype=torch.int32, device=dev)
                    run = lambda: ops.dequant_matmul_slots(x, qt, slots)
                    plain = lambda: ref.dequant_matmul_slots(x, qt, slots)
                    n_read = 2
                else:
                    run = lambda: ops.dequant_matmul_batched(x, qt)
                    plain = lambda: ref.dequant_matmul_batched(x, qt)
                    n_read = c["B"]
                y, yp = run(), plain()
                torch.cuda.synchronize()
                err = (y - yp).abs().max().item()
                scale = yp.abs().max().item()
                if not (err <= KERNEL_RTOL * scale) or not torch.isfinite(y).all():
                    fail(f"{name} {bits}-bit K={K} N={N}: max |kernel - plain| "
                         f"{err:.3g} > {KERNEL_RTOL} x {scale:.3g}")
                ms = _event_ms(run, 20, flush)
                pms = _event_ms(plain, 3, flush)
                nbytes = (_stored_bytes(qt, n_read) + x.numel() * x.element_size()
                          + y.numel() * 4)
                flops = 2 * c["B"] * c["M"] * K * N
                log(f"[kernel] {name} {bits}-bit B={c['B']} M={c['M']} K={K} "
                    f"N={N}: max_abs_err {err:.3g} (max |y| {scale:.3g}) "
                    f"kernel {ms:.4f} ms plain {pms:.4f} ms "
                    f"bytes {nbytes} -> {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
                a = acc[name]
                a["err"] = max(a["err"], err)
                a["rel"] = max(a["rel"], err / scale)
                if bits == 2:
                    a["ms"] += ms
                    a["plain_ms"] += pms
                    a["bytes"] += nbytes
                    a["flops"] += flops
    # tiny-moe's own shapes (3-bit, g = 64, float32 x) through both bindings
    for K, N in ((256, 512), (512, 256)):
        w = torch.randn((8, K, N), generator=gen, device=dev) * 0.05
        qt = hqq.quantize(w, 3)
        x = torch.randn((8, 4, K), generator=gen, device=dev)
        slots = torch.tensor([7, 0, 3, 3, 5, 1, 2, 6], dtype=torch.int32, device=dev)
        for name, y, yp in (
                ("dequant_matmul_slots", ops.dequant_matmul_slots(x, qt, slots),
                 ref.dequant_matmul_slots(x, qt, slots)),
                ("dequant_matmul_batched", ops.dequant_matmul_batched(x, qt),
                 ref.dequant_matmul_batched(x, qt))):
            err = (y - yp).abs().max().item()
            scale = yp.abs().max().item()
            if not err <= KERNEL_RTOL * scale:
                fail(f"{name} tiny-moe shape K={K} N={N}: {err:.3g}")
            acc[name]["err"] = max(acc[name]["err"], err)
            acc[name]["rel"] = max(acc[name]["rel"], err / scale)
    out = {}
    for name, a in acc.items():
        bound_ms, bound_by = _bound(a["bytes"], a["flops"])
        out[name] = {
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": a["err"], "max_rel_err": a["rel"]}
        log(f"[kernel] {name} per MoE layer (3 matrices, 2-bit): "
            f"{json.dumps(out[name])}")
    return out, tiers, flush


def phase_prefill_kernel(dev, tiers, flush, batches):
    """The batched binding at the shapes the main run's prefill launched:
    per MoE layer, U distinct experts with their routed rows grouped and
    zero-padded to the largest group (U, Mmax), for gate, down and up at
    2 bits, x bf16.  Beside it the same rows spread evenly over the
    experts, (U, ceil(rows / U)): the gap is what the padding costs.  The
    bound counts the U experts' stored bytes, x as launched and the output,
    and the operations of the routed rows only.  Returns the per-layer
    means (the kernels line's ``dequant_matmul_batched`` entry)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import hqq
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    per_layer = []
    err_max = rel_max = 0.0
    for l, (U, Mmax, rows) in enumerate(batches):
        even = -(-rows // U)
        t = dict(ms=0.0, even_ms=0.0, plain_ms=0.0, bytes=0, flops=0)
        for K, N in SHAPES:
            full = tiers[2, K, N]
            qt = hqq.QTensor(full.packed[:U], full.scale[:U], full.zero[:U],
                             {k: v[:U] for k, v in full.meta.items()},
                             2, full.group_size, (U, K, N))
            x = torch.randn((U, Mmax, K), generator=gen,
                            device=dev).to(torch.bfloat16)
            xe = x[:, :even].contiguous()
            y, yp = ops.dequant_matmul_batched(x, qt), ref.dequant_matmul_batched(x, qt)
            err = (y - yp).abs().max().item()
            scale = yp.abs().max().item()
            if not (err <= KERNEL_RTOL * scale) or not torch.isfinite(y).all():
                fail(f"batched at prefill shape U={U} M={Mmax} K={K}: {err:.3g}")
            err_max, rel_max = max(err_max, err), max(rel_max, err / scale)
            t["ms"] += _event_ms(lambda: ops.dequant_matmul_batched(x, qt), 10, flush)
            t["even_ms"] += _event_ms(lambda: ops.dequant_matmul_batched(xe, qt), 10, flush)
            t["plain_ms"] += _event_ms(lambda: ref.dequant_matmul_batched(x, qt), 2, flush)
            t["bytes"] += (_stored_bytes(qt, U) + x.numel() * x.element_size()
                           + y.numel() * 4)
            t["flops"] += 2 * rows * K * N
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], t["flops"])
        log(f"[prefill-kernel] layer {l}: {U} experts, {rows} routed rows, "
            f"{U * Mmax} launched (max group {Mmax}, even {even}): kernel "
            f"{t['ms']:.4f} ms, evenly spread {t['even_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        per_layer.append(t)
    mean = lambda k: float(np.mean([t[k] for t in per_layer]))
    out = {"ms": mean("ms"), "even_ms": mean("even_ms"),
           "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
           "bound_by": per_layer[0]["bound_by"],
           "padded_over_routed_rows": sum(U * M for U, M, _ in batches)
           / sum(r for _, _, r in batches),
           "max_abs_err": err_max, "max_rel_err": rel_max}
    log(f"[prefill-kernel] per MoE layer, mean of {len(batches)}: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------------
def _cpu_store_to(store, dev):
    from repro_torch.core import expert_pool as EP
    dst = EP.new_store(store.layout, store.n_layers, store.n_slots, dev)
    dst.buf.copy_(store.buf)
    return dst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_parity(dev):
    """tiny-moe on the card against the same model on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.models import transformer as T
    cfg = get_config("tiny-moe")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, store = quantize_for_offload(params, cfg, spec, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
    runs = {}
    for where in ("cpu", dev):
        eng = OffloadEngine(_to(exec_params, where), cfg, spec,
                            store=store if where == "cpu" else _cpu_store_to(store, where),
                            device=where)
        steps = []
        toks, stats = eng.generate(prompt, 16, on_step=lambda lg, r: steps.append(
            (lg.float().cpu().numpy(), r)))
        runs[str(where)] = (toks, stats, steps, eng)
    (tc, sc, stc, ec), (tg, sg, stg, eg) = runs["cpu"], runs[str(dev)]
    gap = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(stc, stg))
    same_routes = all((x == y).all() for a, b in zip(stc[1:], stg[1:])
                      for x, y in zip(a[1], b[1]))
    log(f"[parity] tiny-moe card vs cpu: tokens equal {bool((tc == tg).all())}, "
        f"routes equal {same_routes}, counters {sg} vs {sc}, max logit gap {gap:.3g}")
    if not (tc == tg).all() or not same_routes or sc != sg or not gap <= LOGIT_ATOL:
        fail("tiny-moe on the card differs from the CPU run")
    if not EP.pool_coherent(eg.store, eg._last_pool_state):
        fail("tiny-moe pool incoherent on the card")
    return {"tokens_equal": True, "max_logit_gap": gap}


# ----------------------------------------------------------------------
def phase_main(dev):
    """mixtral-offload, 8 of 32 layers, through OffloadEngine.generate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import OffloadEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = get_config("mixtral-offload").replace(n_layers=MAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = OffloadEngine(T.init_model(cfg, seed=0, device=dev), cfg,
                        device=dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"[main] {cfg.name} {cfg.n_layers}/32 layers: init + quantize "
        f"{setup_s:.1f} s, store {eng.store.nbytes() / 2**30:.2f} GiB pinned, "
        f"{eng.expert_bytes:.0f} B per expert")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (1, PROMPT_LEN))
    # warm-up run (library handles, allocator), not counted
    eng.generate(prompt[:, :8], 3)
    link = _h2d_rate(eng.store, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    last = []
    tier = eng._exec.prefill_tier
    tier.h2d_bytes = 0
    tier.batches.clear()
    ops.reset_launches()
    toks, stats = eng.generate(prompt, NEW_TOKENS,
                               on_step=lambda lg, r: last.append(lg))
    launches = ops.launches()
    batches = list(tier.batches)
    ps = eng._last_pool_state
    timing = eng.last_timing
    steps = timing["decode_steps"]
    L = eng.n_moe_layers
    expect = {"dequant_matmul_batched": 3 * L, "dequant_matmul_slots": 3 * L * steps}
    logits = torch.stack([lg.float() for lg in last])
    report = {
        "prefill_s": timing["prefill_s"], "decode_s": timing["decode_s"],
        "decode_tok_s": steps / timing["decode_s"],
        "stats": {k: getattr(stats, k) for k in
                  ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads")},
        "bytes_h2d_counters": stats.bytes_h2d, "bytes_h2d_issued": ps.h2d_bytes,
        "prefill_h2d_bytes": tier.h2d_bytes,
        "prefill_batches_experts_maxrows_rows": batches,
        "host_reads_per_token": ps.host_reads / steps,
        "h2d_probe_gb_s": link,
        "pool_staging_gib": (ps.pool.nbytes() + ps.staging.nbytes()) / 2**30,
        "launches": launches, "launches_expected": expect,
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "tokens": toks[0].tolist()}
    log(f"[main] {json.dumps(report)}")
    if launches != expect:
        fail(f"kernel launches {launches} != expected {expect}")
    if ps.h2d_bytes != stats.bytes_h2d:
        fail(f"issued h2d bytes {ps.h2d_bytes} != counters {stats.bytes_h2d}")
    if not torch.isfinite(logits).all() or logits.shape[-1] != cfg.padded_vocab:
        fail("non-finite or misshapen logits")
    if toks.shape != (1, NEW_TOKENS) or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        fail(f"bad tokens {toks}")
    if not EP.pool_coherent(eng.store, ps):
        fail("pool slots do not hold the store bytes of their experts")
    log("[main] pool coherent: every slot holds store[cache_ids[slot]]")
    again = []
    for _ in range(2):  # the same run repeated: the spread of the timings
        t2, _ = eng.generate(prompt, NEW_TOKENS)
        if not (t2 == toks).all():
            fail("a repeated run generated other tokens")
        again.append({"prefill_s": eng.last_timing["prefill_s"],
                      "decode_tok_s": steps / eng.last_timing["decode_s"]})
    log(f"[main] repeats: {json.dumps(again)}")
    _profile_decode(eng, prompt, dev)
    if len(batches) != L:
        fail(f"{len(batches)} prefill kernel batches for {L} MoE layers")
    return launches, batches


def _h2d_rate(store, dev):
    """GB/s of one expert record copied pinned host -> device, alone on
    the link (the floor of a demand load)."""
    import torch
    dst = torch.empty_like(store.record(0, 0), device=dev)
    rates = []
    for e in range(store.n_slots):
        src = store.record(0, e)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        e1.synchronize()
        rates.append(src.numel() / (e0.elapsed_time(e1) * 1e-3) / 1e9)
    return float(np.median(rates))


def _union_ms(spans):
    """Total length (ms) of the union of (start_us, end_us) spans."""
    total, end = 0.0, None
    for s0, s1 in sorted(spans):
        if end is None or s0 > end:
            total += s1 - s0
            end = s1
        elif s1 > end:
            total += s1 - end
            end = s1
    return total / 1e3


def _profile_decode(eng, prompt, dev, steps=8):
    """Where a decode step's time goes: ``steps`` decode steps after a
    64-token prefill, under ``torch.profiler``.  Reports the window's wall
    time and the union of device activity by kind (expert copies h2d,
    device-local copies, the dequant kernel, other kernels), so the idle
    share of the card follows; the Chrome trace goes to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dec = eng._exec
    ps = dec.init_pool_state()
    logits, state = dec.prefill(torch.as_tensor(prompt, dtype=torch.int32),
                                prompt.shape[1] + steps + 1)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state, ps, _ = dec.decode(state, tok, ps)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            int(tok[0, 0])
        torch.cuda.synchronize(dev)
    evs = list(prof.events())
    cuda = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    if not cuda:
        log("[profile] the profiler recorded no device activity: not measured")
        return None
    span = lambda es: [(e.time_range.start, e.time_range.end) for e in es]
    kinds = {
        "h2d_copy": [e for e in cuda if "HtoD" in e.name],
        "d2d_copy": [e for e in cuda if "DtoD" in e.name],
        "dequant_kernel": [e for e in cuda if "dequant_matmul" in e.name],
    }
    used = {id(e) for es in kinds.values() for e in es}
    kinds["other_kernels"] = [e for e in cuda if id(e) not in used
                              and "Memcpy" not in e.name]
    t0 = min(e.time_range.start for e in evs)
    t1 = max(e.time_range.end for e in evs)
    window = (t1 - t0) / 1e3
    out = {k: _union_ms(span(v)) for k, v in kinds.items()}
    compute = _union_ms(span(kinds["dequant_kernel"] + kinds["other_kernels"]))
    busy = _union_ms(span(cuda))
    host_launches = sum(e.name.startswith("cudaLaunchKernel") for e in evs)
    out.update(window_ms=window, per_step_ms=window / steps,
               kernel_launches_per_step=host_launches / steps,
               device_busy_ms=busy, device_idle_share=1 - busy / window,
               compute_idle_share=1 - compute / window,
               h2d_copies=len([e for e in kinds["h2d_copy"]
                               if e.time_range.elapsed_us() > 100]))
    log(f"[profile] {steps} decode steps: {json.dumps(out)}")
    trace = Path(__file__).resolve().parent / "chiprun_out"
    trace.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace / "decode_trace.json"))
    return out


# ----------------------------------------------------------------------
def main():
    card = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    kern, tiers, flush = phase_kernels(dev)
    phase_parity(dev)
    launches, batches = phase_main(dev)
    batched = phase_prefill_kernel(dev, tiers, flush, batches)
    batched["max_abs_err"] = max(batched["max_abs_err"],
                                 kern["dequant_matmul_batched"]["max_abs_err"])
    kern["dequant_matmul_batched"] = batched
    src = "src/repro_torch/kernels/csrc/dequant_matmul.cu"
    replaces = {"dequant_matmul_batched": "src/repro/kernels/dequant_matmul.py:109",
                "dequant_matmul_slots": "src/repro/kernels/dequant_matmul.py:145"}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": replaces[n],
         "launches": launches[n], "max_abs_err": kern[n]["max_abs_err"],
         "ms": kern[n]["ms"], "plain_ms": kern[n]["plain_ms"],
         "bound_ms": kern[n]["bound_ms"], "bound_by": kern[n]["bound_by"],
         "library_ms": None} for n in ("dequant_matmul_batched",
                                       "dequant_matmul_slots")]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
