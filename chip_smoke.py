"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. device: a CUDA device or exit 1; print the card's name and power limit;
   build every kernel from the sources in this checkout (``nvcc``).

Phases 2-4 and 16 run the cases of the port's kernels suite
(``repro_torch.benchmarks.kernels_bench``, also ``python -m
repro_torch.benchmarks.run --only kernels``), which checks, times and
bounds each one and raises on a failed check; phase 4 is followed by the
suite's group (a), the reference's float32 rows (the 2-D binding at 2, 4
and 8 bits, causal flash), each kernel held to its plain version
(``[kernel-ref]`` lines).

2. kernels: each binding of the dequant-matmul kernels (batched, slots
   and the 2-D one) against its plain PyTorch version on the card at the
   main path's shapes (2- and 3-bit codes), with its time, the plain
   version's time and the bound; the slot and 2-D bindings must take the
   tensor-core GEMV (``csrc/dequant_gemv.cu``), and the FMA kernel they
   ran before is checked and timed beside it on the same inputs; the
   slot binding also at the verify chunks' B = 10 and 40 rows.
3. ragged kernel: the paged-attention kernel against its plain version at
   Mixtral's attention shapes (H 32, Hkv 8, hd 128, pages of 16, bf16):
   a decode step of 4 rows (live lengths 37, 300, 1500, 4200, window
   4096), a 128-token admission chunk and 4 rows of C = 5 verify
   chunks, on the tensor-core kernel
   (``csrc/ragged_mma.cu``); time, plain time, bound, and the
   warp-reduction kernel it replaced checked and timed beside it.
4. flash kernel: the flash-attention kernel against its plain version at
   Mixtral's attention shapes (H 32, Hkv 8, hd 128, bf16): the main
   path's 64-token prefill chunk, a 4096-token prompt, a windowed
   1024-row chunk at position 7168 over 8192 keys (window 4096, the
   KV-tile skip) and a C = 5 verify chunk at position 64 over 69 keys;
   time, plain time, bound and, where no window applies,
   ``scaled_dot_product_attention`` as a yardstick (``kernel_over_library``).
5. parity: ``tiny-moe`` generated on the card (kernels) and on the CPU
   (plain versions) from the same seeded weights, on each (pipelined,
   vectorized, fused) combination the reference's offload benchmark
   runs: equal tokens, routing and counters, logits within tolerance.
6. continuous parity: ``tiny-moe`` served by ``ContinuousEngine`` over the
   offloaded pool on paged KV, four requests through two slots, on the
   card (kernels) and on the CPU (plain versions): equal tokens, emit
   steps and counters.
7. plain parity: the plain plane (dense resident weights) on ``tiny-moe``
   and ``tiny-draft`` (f32, seeded weights), card against CPU: equal
   ``generate_plain`` tokens; on ``tiny-moe`` accounting mode
   (``quantized=True, packed=False``) on the card: tokens bitwise equal to
   ``generate_plain`` over the same dequantized weights, counters and
   ``usage`` equal to the packed engine's, sampled runs that repeat from
   a generator seeded with 0, ``SamplerConfig("greedy")`` equal to greedy
   and every top-k draw in its step's top k.
8. serve-plain parity: ``tiny-moe`` (f32, seeded weights) served card
   against CPU: ``ContinuousEngine`` on the plain plane (dense resident
   weights) on the ``dense``, ``dense_chunked``, ``paged``,
   ``paged_exact`` and ``paged_chunked`` overlays of the reference's
   parity harness, the packed engine on dense slots and on pages (whole
   and chunked admission), and ``ServeEngine.serve_batch`` on mixed
   lengths: equal tokens and emit steps card against CPU; on the card
   each plain continuous request equal to ``generate_plain``, and the
   packed dense-slot counters equal to the paged run's.
9. serve-bench: the port's ``benchmarks/serve_bench.run(quick=True)`` on
   the card (``tiny-moe``, random weights): continuous against static,
   chunked-prefill latency on the plain and packed planes, dense slots
   against pages, prefix reuse (TTFT, the reference's 1.5x floor),
   overload with preemption, telemetry overhead (the 0.95x floor),
   chaos goodput (the 0.7x floor) and recurrent decode flat in context
   (``zoo``, reduced ``xlstm-1.3b``, the < 2x floor), each scenario
   asserting its own parities; its rows printed.
10. bf16 parity: ``tiny-moe`` at 4 heads over 2 KV heads (head_dim 64) in
    bf16, inside every tensor-core route's scope, packed ``pipelined``
    batch 1 and ``ContinuousEngine`` (4 requests through 2 slots, pages of
    16), card (kernels) against CPU (plain versions), with the routes
    taken: the slot binding on the GEMV, the batched binding on the
    grouped kernel, flash on ``wgmma``, ragged on ``ragged_mma``; then
    both as draft-and-verify (batch 1: a replay draft missing every third
    proposal; continuous: a random bf16 ``tiny-draft``), held card
    against CPU by position.
10b. spec-parity: draft-and-verify on ``tiny-moe`` (f32) card against
    CPU, exactly equal tokens, counters and speculation totals:
    ``OffloadEngine`` on the three packed planes and accounting with the
    dense ``tiny-draft``, a replay of the baseline and a replay missing
    every third proposal (k = 3), and the replay at k = 1;
    ``ContinuousEngine`` on the plain plane over the five KV overlays and
    the packed engine on dense slots, pages and chunked admission.
10c. item5-parity: ``tiny-moe`` (f32) card against CPU, exactly equal
    tokens, emit steps, statuses and the prefix, host-swap, fault,
    offload and page counters: prefix hits on the plain and packed
    planes, swap resume, recompute resume and priority preemption, the
    chaos schedule with cancelling clients, a cancel while swapped out, a
    step deadline, NaN quarantine on both planes, and every expert fetch
    failing (each decode MoE layer degraded to store-direct).
11. train: ``tiny-moe`` at full size (f32: 6 layers, d 256, 8 experts,
    top-2) trained with the paper-measurement recipe of
    ``repro_torch.benchmarks.common`` (sequences of 128, batches of 8, a
    2 MB byte corpus of the machine's Python standard library, AdamW at lr
    1e-3, 30 warmup steps): weights made on the CPU (seed 0) and copied to
    the card; 5 steps on the card and 5 on the CPU from those weights and
    batches, whose loss, ce, load balance and gradient norm must agree
    within ``TRAIN_RTOL``; then the full 300 steps on the card, with the
    loss curve, final loss, eval ce, ms per step (median after the first
    10), training tokens/s and peak memory; the corpus's byte count and
    md5; the checkpoint saved, restored, and its eval ce equal.
12. main path: ``mixtral-offload`` at full width (depth cut to 8 of 32
    layers), weights from a seeded generator, quantized on the card; a
    64-token prompt prefilled (one chunk, through the flash-attention
    kernel) and 32 tokens generated greedily through
    ``OffloadEngine.generate``, with the kernel launch counts, the h2d
    bytes actually issued against the counters, and pool coherence; one
    prefill profiled, split into the prefill tier's h2d copies and the
    kernels' time.
13. planes: the paper's three offload data planes (the reference's
    ``offload_bench`` variants ``pr2_sync``, ``vectorized``, ``pipelined``)
    on the main phase's model, weights and store: decode tokens/s with
    p50/p95 ms per token, prefill s, counters, h2d bytes issued and the
    launch counts of every binding and route; equal tokens and counters
    across the three, and the 2-D dequant binding launched on ``pr2_sync``
    only.  Then draft-and-verify on each plane (``[spec]``): the baseline,
    then a ``ReplayDraft`` at k = 4 of the stream the speculative path
    produces (acceptance 1.0) and of the same missing every third
    proposal: decode tok/s beside the baseline's, rounds, acceptance,
    tokens per round, h2d bytes per emitted token, hit ratio, launches
    by route; tokens held to the baseline's by position under the
    near-tie rule.  Where ``[main]``'s or ``[serve]``'s counters differ from the
    previous decode kernels' (``PREVIOUS_MAIN``/``PREVIOUS_SERVE``), the run
    is repeated on the FMA decode kernel, whose counters are printed with
    the first decision that differs and its gap.
14. accounting: the dense-resident oracle of ``[main]`` at full width: the
    main store's records dequantized on the card layer by layer (no second
    quantization), generating ``[main]``'s 32 tokens in accounting mode on
    the plain plane (the prompt's one chunk through the flash kernel,
    one launch per layer), with its prefill s, decode tok/s and peak
    device memory (the oracle's times, not an offload result); its tokens
    and PyLRU replay counters against ``[main]``'s packed run.  This holds
    the bf16 tensor-core routes of the packed run end to end against a
    model with no quantized kernel in it.
15. serve-plain: ``mixtral-offload`` (the main phase's 8 layers) with
    ``[accounting]``'s dense bf16 experts serving ``[serve]``'s 8 requests
    through 4 slots on the plain plane, on pages of 16 (the ragged
    kernel) and on dense slot KV (flash on each admission chunk); the
    same requests through ``ServeEngine.serve_batch`` in FCFS groups of 4
    (the static baseline, no kernel); and the packed ``[serve]`` engine
    on dense slot KV over the main pool (flash and the batched binding on
    admission, the slot binding in decode).  Each run's tokens/s, steps,
    launches by binding and route (against the expected) and peak device
    memory; the packed run's counters against the h2d bytes issued; the
    static token count within 25 % of the continuous one; the plain
    paged, plain dense and packed paged runs traced and held to the
    near-tie rule.  The dense weights are freed after it.
16. prefill kernel: the batched binding (the grouped tensor-core kernel)
    timed again at the main run's prefill's per-expert row counts, as
    ragged groups, beside the FMA kernel it replaced on the same rows
    zero-padded to the largest group; then a 4096-token prompt's 8192
    routed rows over 8 experts (operation-bound), with its TFLOP/s.
17. serving: ``mixtral-offload`` (the main phase's 8 layers) serving 8
    requests through 4 slots on paged KV, greedy, FCFS: tokens/s, active
    rows per step, the pool's counters against the h2d bytes issued (and
    beside the previous decode kernels' run), the launch counts of all
    kernel bindings and of each route against the expected, the
    slot binding against its plain version (and timed) on the inputs of
    the decode launch that read farthest into the pool's overflow
    records, and a profiler window over a few decode steps.  Then the
    same requests draft-and-verify (``[spec-serve]``) with a random
    ``tiny-draft`` at the target's vocabulary, k = 4, on pages and on
    dense slots: tokens/s, acceptance, h2d bytes, launches by route;
    tokens held to ``[serve]``'s by position under the near-tie rule.
17b. prefix, preempt, chaos (after ``[spec-serve]``, on the main phase's
    model and pool, pages of 16): ``[prefix]`` serves the reference's full
    prefix-reuse workload (a 160-token system prompt, five tails, 8 new
    tokens, one slot, chunks of 16, a 12-page cache) cold and with the
    cache: time to first token of the follow-ups, prefills skipped, hit
    tokens, the prefill tier's h2d bytes, launches by route, hit tokens
    equal to cold ones.  ``[preempt]`` serves ``[serve]``'s 8 requests
    (priorities ``i % 2``) over a pool of one worst case plus one page:
    stalling admission, preemption with a host pool, preemption by
    recompute; tokens/s, preemptions, swap bytes and GB/s, every staged
    and restored page byte for byte, tokens held to the stall run's by
    position.  ``[chaos]`` serves the reference's chaos workload
    (16 requests, ``expert_fetch=0.05,nan_logits@3``, every 6th client
    cancelling) against the same traffic fault-free: goodput ratio
    (floor 0.7), retries, degraded layers, statuses, launches against
    the expected, the pool empty at teardown, survivors held by position.
18. paper: the paper's measurements on that checkpoint (the port's
    ``benchmarks`` package, on the card): ``fig2_lru`` hit ratios at k 1-8
    with decayed LFU and Belady at k 2 and 4, ``fig2_spec`` recall at
    lookahead 1, 2 and 5 against the experts fetched, the ``table1_quant``
    grid (eval ce, projected Mixtral GB), ``table2_speed``'s H100
    estimates, and ``offload_bench --trained`` on the three planes (decode
    tok/s, p50/p95 ms, prefill s, h2d bytes per token, hit ratio, launches
    by binding and route): tokens equal to ``generate_plain``'s and to the
    CPU run's, counters equal across the planes and to the CPU's.  Then
    the cost model's two overheads fitted to ``[main]``'s pipelined
    decode beside the ones ``cost_model.HARDWARE["h100"]`` holds, and that
    row's ``throughput_estimate`` beside the measured decode tok/s of
    ``[planes]``' ``pr2_sync`` and ``vectorized`` runs, the cells it was
    not fitted to.

Phases 10, 13 (``[spec]``), 14, 15, 17 (``[spec-serve]``) and 17b
(``[preempt]``, ``[chaos]``) trace every
decision of both runs they compare (router
top-k, lookahead prediction, sampled token) and hold them to one rule:
equal, or the first decision that differs is a near-tie, its top-k
probability gap (routing, prediction) or its top-2 logit gap over the
row's largest |logit| over the real vocabulary, pad ids left out (token)
below ``NEAR_TIE`` = 2^-6 in both runs; the decision is printed with its
gap.

19. ``[f4]`` (after ``[item5-parity]``): F4's minimal
    case, chunked admission with preemption on an 11-page pool, on
    ``tiny-moe`` at 2 layers in f32 on the plain and the packed plane,
    card against CPU (tokens, emit steps, preemptions, every page back).
    ``[telemetry]`` (after ``[serve]``): ``[serve]``'s requests through
    the ported ``serve_bench.run_telemetry_overhead`` on the packed engine
    (telemetry fully on against off, equal tokens, the 0.95 floor), host
    syncs per decode step on and off (``torch.cuda.set_sync_debug_mode``),
    a traced run held to ``[serve]``'s tokens with its step / exec /
    roofline numbers, and ``[main]``'s ``OffloadEngine`` traced, held to
    ``[main]``'s tokens; each metrics and trace file through the port's
    schema checker (``repro_torch.obs.check_schema``).
    ``[attention-bench]`` (after ``[paper]``): the ported
    ``attention_bench`` (dense ring against ``ragged_mma`` as the live
    context sweeps 1/8 to full; work-list lengths).  ``[cli]`` (last):
    ``python -m repro_torch.launch.serve --config mixtral-offload
    --offload --quantize --max-new 8`` at the published 32 layers (setup
    s, decode tok/s, peak memory, the roofline), ``launch.train`` of
    ``tiny-moe`` for 20 steps into a checkpoint that ``launch.serve``
    serves continuously with the prefix cache, preemption, injected
    fetch faults and the packed plane; each must exit 0 and its files
    pass the schema tool.

20. The attention-only config zoo (ROADMAP item 6, sub-items 1-2).
    ``[ragged-hd96]`` and ``[flash-hd96]`` (after ``[flash]``): the two
    attention kernels at phi-3-vision's shapes (H 32, Hkv 32, head_dim
    96, bf16): a 4-row decode step over pages of 16 and the 64-token
    prefill chunk, with route, time, plain time and bound, as above.
    ``[zoo-parity]`` (after ``[f4]``): the six zoo configs reduced, in
    f32, card against CPU, exactly equal: ``generate_plain`` tokens, the
    plain plane's ``ContinuousEngine`` on pages and on dense slots with
    chunks of 4 (4 requests through 2 slots: tokens and emit steps);
    granite kept at 32 experts / top-8 / cache 8 (widths cut by hand)
    and a tail-layer config through ``OffloadEngine`` on
    ``packed_pipelined`` (tokens and every counter); a softcap config;
    phi-3 at head_dim 96 and the GQA ratios 3 and 12 on pages and dense
    slots.
    ``[zoo]`` (after ``[attention-bench]``): published widths in bf16,
    seed 0: granite at 24 layers batch 1 on ``packed_pipelined`` (64-token
    prompt, 32 new tokens: prefill s, decode tok/s, hit ratio, h2d bytes
    per token, peak memory, launches on the GEMV and the grouped kernel)
    and served on its pool; smollm, stablelm, qwen, phi-3 at full depth
    and command-r-plus at 8 of 64 layers served on the plain plane, each
    ``[serve]``'s 8 requests through 4 slots on pages of 16 (tokens/s,
    peak memory, routes); each held, over its first 12-16 tokens, to the
    same run with the plain versions on the card by the near-tie rule.  ``[cli]`` also
    serves ``--arch granite-moe-1b-a400m --offload --quantize`` and
    ``--arch smollm-360m --continuous``, and checks that
    ``--arch command-r-plus-104b`` is refused with the bytes it needs.

21. The recurrent config zoo (ROADMAP item 6, sub-items 3 and 5).
    ``[ragged-hd256]`` and ``[flash-hd256]`` (after ``[flash-hd96]``): the
    two attention kernels at recurrentgemma-9b's shapes (H 16, Hkv 1,
    head_dim 256, bf16, window 2048): a 4-row decode step over pages of
    16 (lens 64/300/1500/4000) and a 128-token admission chunk; the
    64-token chunk, a 1024-row chunk at position 1024 over 2048 keys and
    a C = 5 verify chunk; route (flash must take ``wgmma``, ragged
    ``mma``), time, plain time, bound and SDPA as above.  ``[rec-parity]`` (after ``[zoo-parity]``): reduced
    recurrentgemma and xlstm in f32, card against CPU, exactly equal:
    ``generate_plain`` tokens, the plain ``ContinuousEngine`` on pages
    (xlstm on a one-page pool, no page reserved) and on dense slots with
    chunks of 4, and draft-and-verify on dense slots (4 requests through 2
    slots: tokens and emit steps).  ``[zoo-rec]`` (after ``[zoo]``):
    published widths in bf16, seed 0, depth cut for the script's time
    limit (``ZOO_REC_LAYERS``; ``[cli]`` serves both at full depth):
    recurrentgemma-9b (14 of 38 layers: four periods and the two tail
    layers) serving ``[serve]``'s 8 requests through 4 slots on pages of
    16 and on dense slots with chunks of 32; xlstm-1.3b (12 of 48 layers,
    two periods) at batch 1 and served on pages with no page in use;
    tokens/s, admission s against decode s, ms per layer per decode
    step, peak memory, launches against the expected on the routes, the
    recurrent state bytes per row equal to ``recurrent_state_bytes``; each
    served run held over 12 tokens of 4 requests to the run with the plain
    versions by the near-tie rule.  ``[serve-bench]`` runs the ``zoo``
    scenario (its < 2x context-flatness floor); ``[cli]`` also serves
    ``--config xlstm-1.3b --continuous`` and ``--config recurrentgemma-9b
    --continuous``.

22. The encoder-decoder (ROADMAP item 6, sub-item 4).
    ``[ragged-whisper]`` and ``[flash-whisper]`` (after ``[flash-hd256]``):
    the two attention kernels at whisper-medium's shapes (H 16, Hkv 16,
    head_dim 64, bf16, no window): a 4-row decode step over pages of 16
    and a 128-token admission chunk; the causal 64-token chunk and the
    non-causal cases: the encoder's 1500 x 1500 self-attention,
    cross-attention at decode (4 rows x 1 query over 1500 frames) and of a
    64-token chunk over 1500 frames; route (flash must take ``wgmma``,
    ragged ``mma``), time, plain time, bound and SDPA (``is_causal`` as
    the case) as above.  ``[whisper-parity]`` (after ``[rec-parity]``):
    reduced whisper in f32 (2 + 2 layers, 24 frames) with a seeded
    frontend per request, card against CPU, exactly equal:
    ``generate_plain`` tokens, the plain ``ContinuousEngine`` on pages, on
    dense slots with chunks of 4, and draft-and-verify (f32 ``tiny-draft``,
    k = 2) on dense slots and on pages (4 requests through 2 slots: tokens
    and emit steps).  ``[whisper]`` (after ``[zoo-rec]``): whisper-medium
    at its published widths, depth cut to 8 + 8 of 24 + 24 layers for the
    script's time limit (``[cli]`` serves it at full depth; 1500 frames)
    in bf16, seed 0, ``[serve]``'s 8 requests through 4 slots on pages of
    16 and on dense slots with chunks of 32: tokens/s, encoder, admission
    and decode seconds, ms per layer per decode step, peak memory, every
    flash launch (cross-attention per step and chunk, the encoder's per
    request) on ``wgmma`` and every ragged one on ``mma``, the encoder-KV
    bytes per row equal to ``admission_cost().enc_kv_bytes``; each held
    over 12 tokens of 4 requests to the run with the plain versions by
    the near-tie rule.  ``[cli]`` also serves ``--config whisper-medium
    --continuous --max-new 8`` (12 requests, published width) and checks
    that static mode is refused with the reference's message.

Before the kernels line, ``[phases]`` gives each phase's wall seconds
and the script's total.  The line before the card's line is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

LOGIT_ATOL = 1e-3            # tiny-moe f32 logits, card vs CPU
NEAR_TIE = 2 ** -6           # a difference between two runs must start at a
                             # decision this close (phases 12-13): routing
                             # probabilities, or a token's top-2 logit gap
                             # over its row's largest |logit|
TRAIN_RTOL = 1e-5            # card vs CPU training metrics over 5 steps,
                             # relative: f32 products in another order
                             # (cuBLAS vs the CPU's BLAS), grown by Adam,
                             # which turns a round-off-sized gradient into
                             # a step of the learning rate (1.1e-7 measured
                             # on an H100, PERF.md)
TRAIN_PARITY_STEPS = 5
MAIN_LAYERS = 8              # depth cut of mixtral-offload
PROMPT_LEN, NEW_TOKENS = 64, 32
PLANES = {"pr2_sync": dict(pipelined=False, vectorized=False),
          "vectorized": dict(pipelined=False, vectorized=True),
          "pipelined": dict(pipelined=True, vectorized=True)}
PARITY_PLANES = [dict(pipelined=True, vectorized=True, fused=True),
                 dict(pipelined=False, vectorized=True, fused=True),
                 dict(pipelined=False, vectorized=False, fused=True),
                 dict(pipelined=False, vectorized=True, fused=False)]
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS = 8, 24, 4
SPEC_K = 4                   # draft tokens per round, [spec] and [spec-serve]
SPEC_MISSES = (0, 3)         # ReplayDraft miss_every: 0 = acceptance 1.0
SPEC_PARITY_K = 3            # the reference's test matrix
SPEC_FIXED_POINT = 8         # replay passes to reach the verify chunks' own stream
# the counters the previous decode kernels (the FMA GEMV, the warp-reduction
# ragged kernel) gave at these seeds, with attention quantized as the
# reference does (on its period-stacked leaves), on an NVIDIA H100 80GB HBM3:
# a new summation order may flip a near-tie, which the run then explains
PREVIOUS_MAIN = {"hits": 362, "spec_hits": 63, "demand_loads": 71,
                 "spec_loads": 118, "bytes_h2d": 12_615_450_624}
PREVIOUS_SERVE = {"hits": 1417, "demand_loads": 1527, "overflow_accesses": 699,
                  "bytes_h2d": 101_924_831_232}


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
    reports = build.compile_all()  # one nvcc per source, all at once
    for name, report in reports.items():
        regs = sorted({ln.strip() for ln in report.splitlines()
                       if "registers" in ln or "spill" in ln or "C75" in ln})
        log(f"[build] {name}.cu: " + " | ".join(regs))
    log(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------------
def _routes():
    """Launches by route of the dequant, ragged and flash bindings."""
    from repro_torch.kernels import ops
    return ops.routes()


def _routes_since(before):
    return {k: v - before[k] for k, v in _routes().items()}


def _token_gap(logits):
    """Each row's top two logits' gap over its largest |logit|, over the
    real vocabulary only: ``unembed`` gives a padded id ``NEG_INF``, which
    would make every row's denominator 1e30."""
    from repro_torch.models.layers import NEG_INF
    x = logits.float()
    pad = x <= NEG_INF / 2
    top = x.masked_fill(pad, float("-inf")).sort(-1, descending=True).values
    scale = x.abs().masked_fill(pad, 0.0).amax(-1).clamp_min(1e-30)
    return (top[:, 0] - top[:, 1]) / scale


class _Decisions:
    """Every decision of one run, copied to the host with the gap a
    perturbation must cross to flip it: each router top-k
    (``moe.route_topk``: the k-th minus the (k+1)-th probability), each
    lookahead prediction (``speculative.predict_experts``: the same over
    the softmax of the lookahead router's logits) and each token sampled
    by an engine passed to :meth:`watch` (the top two logits' gap over
    the row's largest |logit|: a probability gap over a whole vocabulary
    of near-uniform logits would be tiny whatever the logits).  A
    decision's key, (step, index within the step, kind), lines two runs
    up whatever order their planes make the calls in.  Inside a watched
    continuous engine's batched decode only the rows in use are recorded:
    a free slot computes on whatever its KV holds, which differs between
    KV layouts and planes and decides nothing."""

    KINDS = ("route", "predict", "token")

    def __init__(self):
        self.events = {k: [] for k in self.KINDS}
        self.step, self.index = 0, {"route": 0, "predict": 0}
        self.rows = None  # the batched decode's rows in use, while it runs
        self._undo = []

    def _record(self, kind, chosen, scores, k):
        import torch
        if self.rows is not None and chosen.shape[0] > len(self.rows):
            sel = torch.as_tensor(self.rows, device=chosen.device)
            chosen, scores = chosen[sel], scores[sel]
        top = torch.sort(scores.float(), -1, descending=True).values
        key = (self.step, self.index[kind], self.KINDS.index(kind))
        self.events[kind].append((key, np.sort(chosen.cpu().numpy(), -1),
                                  (top[:, k - 1] - top[:, k]).cpu().numpy()))
        self.index[kind] += 1

    def _token(self, logits, picked):
        rel = _token_gap(logits)
        self.events["token"].append(((self.step, 1 << 30, 2),
                                     np.asarray(picked).reshape(-1, 1),
                                     rel.cpu().numpy()))
        self.step, self.index = self.step + 1, {"route": 0, "predict": 0}

    def watch(self, engine):
        """Record the tokens ``engine`` samples (an ``OffloadEngine`` or a
        ``ContinuousEngine``) until the trace ends."""
        if hasattr(engine, "_sample_rows"):
            fn = engine._sample_rows

            def rows(logits, reqs):
                out = fn(logits, reqs)
                sel = (slice(None) if logits.shape[0] == len(reqs)
                       else [r.slot for r in reqs])
                self._token(logits[sel], out[sel])
                return out
            engine._sample_rows, name = rows, "_sample_rows"
            self._watch_decode(engine._exec)
        else:
            fn = engine._next_token

            def nxt(rng, logits, sampler):
                tok = fn(rng, logits, sampler)
                self._token(logits[:, -1], tok[:, 0].cpu().numpy())
                return tok
            engine._next_token, name = nxt, "_next_token"
        self._undo.append(lambda: delattr(engine, name))
        return engine

    def _watch_decode(self, ex):
        """Mark the rows in use during ``ex``'s decode; on the plain plane,
        where greedy decode takes its argmax on the device
        (``decode_sampled``), also record its tokens from the logits."""
        import torch
        dec = ex.decode

        def decode(state, tokens, pstate=None, active=None, **kw):
            self.rows = None if active is None else np.flatnonzero(active)
            try:
                return dec(state, tokens, pstate, active, **kw)
            finally:
                self.rows = None
        ex.decode = decode
        self._undo.append(lambda: ex.__dict__.pop("decode", None))
        if ex.packed:
            return

        def sampled(state, tokens, *, collect_info, greedy, active=None,
                    obs=None):
            logits, state, _, infos = ex.decode(state, tokens, active=active,
                                                collect_info=collect_info,
                                                obs=obs)
            last = logits[:, -1]
            nxt = torch.argmax(last, dim=-1).to(torch.int32) if greedy else last
            if greedy:
                sel = torch.as_tensor(np.flatnonzero(active), device=last.device)
                self._token(last[sel], nxt[sel].cpu().numpy())
            return (nxt, state, infos) if collect_info else (nxt, state)
        ex.decode_sampled = sampled
        self._undo.append(lambda: ex.__dict__.pop("decode_sampled", None))

    def __enter__(self):
        import torch
        from repro_torch.core import speculative
        from repro_torch.models import moe
        route, predict = moe.route_topk, speculative.predict_experts

        def traced_route(p, spec, x2d):
            w, ids, probs = route(p, spec, x2d)
            self._record("route", ids, probs, spec.top_k)
            return w, ids, probs

        def traced_predict(router_w, hidden, n_spec):
            ids = predict(router_w, hidden, n_spec)
            probs = torch.softmax(hidden.float() @ router_w.float(), -1)
            self._record("predict", ids, probs, n_spec)
            return ids

        moe.route_topk, speculative.predict_experts = traced_route, traced_predict
        self._undo.append(lambda: setattr(moe, "route_topk", route))
        self._undo.append(lambda: setattr(speculative, "predict_experts", predict))
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def counts(self):
        return {k: len(v) for k, v in self.events.items()}


def _trace(run, previous=False):
    """``run(decisions)`` under a :class:`_Decisions` trace; with
    ``previous`` the slot and 2-D dequant bindings run the FMA kernel (the
    previous decode kernel) instead of the tensor-core GEMV.  Returns
    (decisions, what ``run`` returned)."""
    from repro_torch.kernels import dequant_matmul as DM
    launch = DM.launch
    if previous:
        DM.launch = DM._launch_fma
    try:
        with _Decisions() as d:
            out = run(d)
    finally:
        DM.launch = launch
    return d, out


def _first_difference(a, b):
    """The first decision, by key, where traces ``a`` and ``b`` differ:
    (key, kind, row, choice in a, choice in b, the larger of the two
    runs' gaps there); None when every decision is equal."""
    found = []
    for kind in _Decisions.KINDS:
        ea, eb = a.events[kind], b.events[kind]
        for (key, ia, ga), (_, ib, gb) in zip(ea, eb):
            if ia.shape != ib.shape:
                found.append((key, kind, 0, ia[:1], ib[:1], float("inf")))
                break
            rows = np.flatnonzero((ia != ib).any(-1))
            if rows.size:
                r = int(rows[0])
                found.append((key, kind, r, ia[r], ib[r], float(max(ga[r], gb[r]))))
                break
        else:
            if len(ea) != len(eb):
                end = ea[len(eb)][0] if len(ea) > len(eb) else eb[len(ea)][0]
                found.append((end, kind, 0, None, None, float("inf")))
    return min(found, key=lambda f: f[0]) if found else None


def _describe(diff, names):
    key, kind, row, ca, cb, gap = diff
    what = ("relative top-2 logit gap" if kind == "token"
            else "top-k probability gap")
    where = "" if kind == "token" else f" (#{key[1]} of its kind in the step)"
    show = lambda c: None if c is None else c.tolist()
    return (f"{kind} decision at step {key[0]}{where}, row {row}: {show(ca)} "
            f"({names[0]}) vs {show(cb)} ({names[1]}); {what} {gap:.3g}")


def _hold_to_near_tie(label, a, b, names):
    """Print the first decision where traces ``a`` and ``b`` differ, with
    its gap, and fail unless it is a near-tie (gap below ``NEAR_TIE``).
    Returns the difference, None when every decision is equal."""
    diff = _first_difference(a, b)
    if diff is None:
        log(f"[{label}] every decision equal ({names[0]} vs {names[1]}): "
            f"{a.counts()}")
        return None
    log(f"[{label}] first decision that differs: {_describe(diff, names)}; "
        f"limit {NEAR_TIE:.3g}")
    if not diff[5] < NEAR_TIE:
        fail(f"{label}: {names[0]} and {names[1]} differ from a decision that "
             f"is no near-tie: {_describe(diff, names)}")
    return diff


def _explain_difference(label, run):
    """``run(decisions)`` (which returns the run's counters) on the
    tensor-core GEMV and on the previous decode kernel: the previous
    kernel's counters and the first decision that differs, with its gap
    (a near-tie, not a fault)."""
    new, _ = _trace(run, False)
    old, counters = _trace(run, True)
    diff = _first_difference(new, old)
    where = ("every decision equal" if diff is None else
             f"first decision that differs: {_describe(diff, ('new', 'previous'))}")
    log(f"[{label}] rerun on the previous decode kernel: counters {counters}; "
        f"{where}")


class _PosTrace:
    """Every routing and token decision of the target's calls in one run,
    keyed by (request, position, kind, layer): the key that lines up a
    draft-and-verify run with plain decode (or the card with the CPU),
    whose steps differ.  A later call that recomputes a position replaces
    its decisions (the next round recomputes a rejected verify row), so
    the trace ends with each position's canonical decisions.  Only the
    watched executor's calls count (a draft's do not), and only rows in
    use.  ``slot_req(slot)`` names the request a batch row holds (None:
    not recorded); ``state_slot(state)`` the slot a dense admission's row
    state belongs to; ``prompt_len(req)`` says which prefill row decides
    the first generated token.  Routing: the k-th minus the (k+1)-th
    probability; tokens: the top-2 logit gap over the row's largest
    |logit|."""

    def __init__(self, ex, slot_req, state_slot, prompt_len):
        self.ex, self.slot_req = ex, slot_req
        self.state_slot, self.prompt_len = state_slot, prompt_len
        self.ev, self.rows, self.layer, self._undo = {}, None, 0, []

    def _put(self, key_of, chosen, top, k):
        import torch
        sel = [t for t, key in enumerate(key_of) if key is not None]
        if not sel:
            return
        idx = torch.as_tensor(sel, device=chosen.device)
        if k:
            top = torch.sort(top[idx].float(), -1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
        else:
            gap = _token_gap(top[idx])
        ch = chosen[idx]
        ch = (torch.sort(ch, -1).values if k else ch).cpu().numpy()
        for i, (c, g) in enumerate(zip(ch, gap.cpu().numpy())):
            self.ev[key_of[sel[i]]] = (np.asarray(c).tolist(), float(g))

    def _call(self, name, fn):
        import torch

        def traced(state, tokens, *a, **kw):
            B, C = tokens.shape
            if name == "decode":
                active = a[1] if len(a) > 1 else kw.get("active")
                slots = [(b, b) for b in range(B)
                         if active is None or active[b]]
            elif name == "prefill_chunk_row":
                slots = [(0, a[0])]
            else:
                slots = [(0, self.state_slot(state))]
            pos = state["pos"]
            rows = [None] * (B * C)
            for b, s in slots:
                req = self.slot_req(s)
                p0 = int(pos if np.ndim(pos) == 0 else pos[s])
                for j in range(C):
                    rows[b * C + j] = None if req is None else (req, p0 + j)
            self.rows, self.layer = rows, 0
            try:
                out = fn(state, tokens, *a, **kw)
            finally:
                self.rows = None
            logits = out[0].reshape(B * C, -1)
            toks = [None] * (B * C)
            for t, key in enumerate(rows):
                if key is None:
                    continue
                last = name == "decode" or key[1] + 1 == self.prompt_len(key[0])
                toks[t] = (key[0], key[1], 1, 0) if last else None
            self._put(toks, torch.argmax(logits, -1), logits, 0)
            return out
        return traced

    def __enter__(self):
        from repro_torch.models import moe
        route = moe.route_topk

        def traced_route(p, spec, x2d):
            w, ids, probs = route(p, spec, x2d)
            if self.rows is not None:
                self._put([None if r is None else (r[0], r[1], 0, self.layer)
                           for r in self.rows], ids, probs, spec.top_k)
                self.layer += 1
            return w, ids, probs
        moe.route_topk = traced_route
        self._undo.append(lambda: setattr(moe, "route_topk", route))
        for name in ("decode", "prefill_chunk", "prefill_chunk_row"):
            setattr(self.ex, name, self._call(name, getattr(self.ex, name)))
            self._undo.append(lambda n=name: self.ex.__dict__.pop(n, None))
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def _pos_trace_offload(eng, S):
    """A :class:`_PosTrace` of an ``OffloadEngine``'s batch-1 run of a
    prompt of S tokens (request 0)."""
    return _PosTrace(eng._exec, lambda s: 0, lambda st: 0, lambda r: S)


def _pos_trace_serving(ce, prompts):
    """A :class:`_PosTrace` of a ``ContinuousEngine`` serving ``prompts``,
    submitted in order: request i is the i-th submitted."""
    first = []

    def req(slot):
        if not first:  # rids count up from the first request submitted
            first.append(min(q.rid for q in ce.sched.running
                             + list(ce.sched.waiting)))
        return next((r.rid - first[0] for r in ce.sched.running
                     if r.slot == slot), None)

    def state_slot(state):
        return next(a.slot for a in ce._admissions if a.state is state)
    return _PosTrace(ce._exec, req, state_slot, lambda r: len(prompts[r]))


def _traced_serve(eng, cfg, prompts, news, **kw):
    """:func:`_serve` under a :class:`_PosTrace` of the engine it makes.
    Returns (trace, what ``_serve`` returned)."""
    held = []

    def watch(ce):
        held.append(_pos_trace_serving(ce, prompts).__enter__())
    try:
        out = _serve(eng, cfg, prompts, news, on_engine=watch, **kw)
    finally:
        if held:
            held[0].__exit__()
    return held[0], out


def _hold_positions(label, a, b, names, tokens_equal):
    """Per request, the first decision (in position order) where traces
    ``a`` and ``b`` differ, printed with its gap; fails unless each is a
    near-tie (gap below ``NEAR_TIE`` in both runs), or when the tokens
    differ and no decision does.  Returns the number of requests with a
    difference."""
    reqs = sorted({k[0] for k in a.ev} | {k[0] for k in b.ev})
    found = 0
    for r in reqs:
        keys = sorted(k for k in a.ev if k[0] == r and k in b.ev)
        diff = next((k for k in keys if a.ev[k][0] != b.ev[k][0]), None)
        if diff is None:
            continue
        found += 1
        gap = max(a.ev[diff][1], b.ev[diff][1])
        kind = "token" if diff[2] else f"route (layer {diff[3]})"
        log(f"[{label}] request {r}: first decision that differs at position "
            f"{diff[1]}: {kind} {a.ev[diff][0]} ({names[0]}) vs "
            f"{b.ev[diff][0]} ({names[1]}), gap {gap:.3g}; limit {NEAR_TIE:.3g}")
        if not gap < NEAR_TIE:
            fail(f"{label}: {names[0]} and {names[1]} differ from a decision "
                 f"that is no near-tie (request {r}, position {diff[1]}, "
                 f"{kind}, gap {gap:.3g})")
    log(f"[{label}] {len(reqs) - found} of {len(reqs)} requests with every "
        f"decision equal ({names[0]} vs {names[1]}), "
        f"{len(a.ev)} / {len(b.ev)} decisions traced")
    if found == 0 and not tokens_equal:
        fail(f"{label}: every decision equal but the tokens differ")
    return found


# ----------------------------------------------------------------------
def phase_kernels(dev):
    """Phases 2-4 through the port's kernels suite
    (``repro_torch.benchmarks.kernels_bench``): its group (b) dequant and
    attention cases (each kernel against its plain version at the main
    path's and the zoo's shapes, on its tensor-core route, timed cold
    beside its bound, the kernel it replaced and SDPA; the suite raises on
    a failed check), then its group (a) rows on the card (the reference's
    f32 shapes: the 2-D binding at 2, 4 and 8 bits and causal flash, each
    held to its plain version).  Returns (the kernels line's entries, the
    8-expert tiers, the L2 flush buffer) for ``[prefill-kernel]``."""
    from repro_torch.benchmarks import kernels_bench as KB
    if KB.CHUNK != PROMPT_LEN:
        fail(f"the suite's prefill chunk {KB.CHUNK} is not the main path's "
             f"{PROMPT_LEN}-token prompt")
    flush = KB.new_flush(dev)
    records, tiers = KB.dequant_cases(dev, flush)
    records += KB.attention_cases(dev, flush)
    kern = KB.entries(records)
    for r in KB.reference_rows(dev):
        log(f"[kernel-ref] {json.dumps(r)}")
        binding = ("dequant_matmul" if r["name"].startswith("dequant_matmul_cuda")
                   else "flash_attention" if r["name"] == "flash_attention_cuda"
                   else None)
        if binding:
            kern[binding]["max_abs_err"] = max(kern[binding]["max_abs_err"],
                                               r["max_abs_err"])
    return kern, tiers, flush


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
    """tiny-moe on the card against the same model on the CPU, on each
    (pipelined, vectorized, fused) combination of ``PARITY_PLANES``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.models import transformer as T
    cfg = get_config("tiny-moe")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
    card_params, card_store = _to(exec_params, dev), _cpu_store_to(store, dev)
    gaps = []
    for flags in PARITY_PLANES:
        runs = {}
        for where in ("cpu", dev):
            eng = OffloadEngine(exec_params if where == "cpu" else card_params,
                                cfg, spec, quantized=True,
                                store=store if where == "cpu" else card_store,
                                device=where, **flags)
            steps = []
            toks, stats = eng.generate(prompt, 16, on_step=lambda lg, r: steps.append(
                (lg.float().cpu().numpy(), r)))
            runs[str(where)] = (toks, stats, steps, eng)
        (tc, sc, stc, ec), (tg, sg, stg, eg) = runs["cpu"], runs[str(dev)]
        gap = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(stc, stg))
        same_routes = all((x == y).all() for a, b in zip(stc[1:], stg[1:])
                          for x, y in zip(a[1], b[1]))
        log(f"[parity] tiny-moe {flags} card vs cpu: tokens equal "
            f"{bool((tc == tg).all())}, routes equal {same_routes}, counters "
            f"{sg} vs {sc}, max logit gap {gap:.3g}")
        if not (tc == tg).all() or not same_routes or sc != sg or not gap <= LOGIT_ATOL:
            fail(f"tiny-moe on the card differs from the CPU run ({flags})")
        if not EP.pool_coherent(eg.store, eg._last_pool_state):
            fail(f"tiny-moe pool incoherent on the card ({flags})")
        gaps.append(gap)
    return {"tokens_equal": True, "max_logit_gap": max(gaps)}


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
                        quantized=True, device=dev)
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
    latency = _copy_latency(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    last = []
    tier = eng._exec.prefill_tier
    tier.h2d_bytes = 0
    tier.batches.clear()
    ops.reset_launches()
    before = _routes()
    toks, stats = eng.generate(prompt, NEW_TOKENS,
                               on_step=lambda lg, r: last.append(lg))
    launches = ops.launches()
    routes = _routes_since(before)
    batches = list(tier.batches)
    ps = eng._last_pool_state
    timing = eng.last_timing
    steps = timing["decode_steps"]
    L = eng.n_moe_layers
    # one 64-token prefill chunk: every attention layer through the flash
    # kernel; decode attends over the dense ring (attention_core)
    expect = {"dequant_matmul": 0, "dequant_matmul_batched": 3 * L,
              "dequant_matmul_slots": 3 * L * steps,
              "flash_attention": cfg.n_layers, "ragged_attention": 0}
    logits = torch.stack([lg.float() for lg in last])
    report = {
        "prefill_s": timing["prefill_s"], "decode_s": timing["decode_s"],
        "decode_tok_s": steps / timing["decode_s"],
        "stats": {k: getattr(stats, k) for k in
                  ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads")},
        "bytes_h2d_counters": stats.bytes_h2d, "bytes_h2d_issued": ps.h2d_bytes,
        "prefill_h2d_bytes": tier.h2d_bytes,
        "prefill_group_counts": batches,
        "host_reads_per_token": ps.host_reads / steps,
        "h2d_probe_gb_s": link, "copy_latency_probe_s": latency,
        "pool_staging_gib": (ps.pool.nbytes() + ps.staging.nbytes()) / 2**30,
        "launches": launches, "launches_expected": expect, "routes": routes,
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "tokens": toks[0].tolist()}
    log(f"[main] {json.dumps(report)}")
    if launches != expect:
        fail(f"kernel launches {launches} != expected {expect}")
    if routes["dequant_gemv"] != expect["dequant_matmul_slots"] or routes["dequant_fma"]:
        fail(f"decode did not run the tensor-core GEMV on every slot launch: {routes}")
    counters = {**{k: getattr(stats, k) for k in PREVIOUS_MAIN if k != "bytes_h2d"},
                "bytes_h2d": stats.bytes_h2d}
    log(f"[main] counters {counters} beside the previous decode kernel's "
        f"{PREVIOUS_MAIN}: equal {counters == PREVIOUS_MAIN}")
    if counters != PREVIOUS_MAIN:
        def main_counters(d):
            st = d.watch(eng).generate(prompt, NEW_TOKENS)[1]
            return {**{k: getattr(st, k) for k in PREVIOUS_MAIN if k != "bytes_h2d"},
                    "bytes_h2d": st.bytes_h2d}
        _explain_difference("main", main_counters)
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
    if len(batches) != L:
        fail(f"{len(batches)} prefill kernel batches for {L} MoE layers")
    report["decode_tok_s_runs"] = [report["decode_tok_s"]] + [
        r["decode_tok_s"] for r in again]
    return launches, batches, eng, cfg, prompt, (toks, stats), report


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


def _copy_latency(dev, nbytes=4096, reps=50):
    """Median seconds of one small pinned host -> device copy (the fixed
    cost of a copy, timed with CUDA events)."""
    import torch
    src = torch.empty((nbytes,), dtype=torch.uint8).pin_memory()
    dst = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) * 1e-3)
    return float(np.median(times))


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


def _device_split(prof, steps, label, trace_name):
    """The union of device activity by kind over a profiled window of
    ``steps`` steps (expert copies h2d, device-local copies, the dequant
    kernels, the ragged kernel, the flash kernel, other kernels) beside
    the window's wall
    time, so the idle share of the card follows; the Chrome trace goes to
    the git-ignored output directory beside this script."""
    import torch
    evs = list(prof.events())
    cuda = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    if not cuda:
        log(f"[{label}] the profiler recorded no device activity: not measured")
        return None
    span = lambda es: [(e.time_range.start, e.time_range.end) for e in es]
    kinds = {
        "h2d_copy": [e for e in cuda if "HtoD" in e.name],
        "d2d_copy": [e for e in cuda if "DtoD" in e.name],
        "dequant_kernel": [e for e in cuda if "dequant_" in e.name],
        "ragged_kernel": [e for e in cuda if "ragged_" in e.name],
        "flash_kernel": [e for e in cuda if "flash_" in e.name],
    }
    used = {id(e) for es in kinds.values() for e in es}
    kinds["other_kernels"] = [e for e in cuda if id(e) not in used
                              and "Memcpy" not in e.name]
    t0 = min(e.time_range.start for e in evs)
    t1 = max(e.time_range.end for e in evs)
    window = (t1 - t0) / 1e3
    out = {k: _union_ms(span(v)) for k, v in kinds.items()}
    compute = _union_ms(span(kinds["dequant_kernel"] + kinds["ragged_kernel"]
                             + kinds["flash_kernel"] + kinds["other_kernels"]))
    busy = _union_ms(span(cuda))
    host_launches = sum(e.name.startswith("cudaLaunchKernel") for e in evs)
    out.update(window_ms=window, per_step_ms=window / steps,
               kernel_launches_per_step=host_launches / steps,
               device_busy_ms=busy, device_idle_share=1 - busy / window,
               compute_idle_share=1 - compute / window,
               h2d_copies=len([e for e in kinds["h2d_copy"]
                               if e.time_range.elapsed_us() > 100]))
    log(f"[{label}] {steps} steps: {json.dumps(out)}")
    trace = Path(__file__).resolve().parent / "chiprun_out"
    trace.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace / trace_name))
    return out


def _profile_decode(eng, prompt, dev, steps=8):
    """Where a batch-1 decode step's time goes: ``steps`` decode steps
    after a 64-token prefill, under ``torch.profiler``."""
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
    return _device_split(prof, steps, "profile", "decode_trace.json")


def _profile_prefill(eng, prompt, dev):
    """Where the 64-token prefill's time goes: one prefill (the main run's
    prompt) under ``torch.profiler``: the prefill tier's h2d expert copies,
    the grouped dequant kernel, the flash kernel and the rest, beside the
    prefill's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dec = eng._exec
    x = torch.as_tensor(prompt, dtype=torch.int32)
    dec.prefill(x, prompt.shape[1] + 2)  # warm (allocator)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.prefill(x, prompt.shape[1] + 2)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    split = _device_split(prof, 1, "prefill-profile", "prefill_trace.json")
    if split is not None:
        log(f"[main] prefill split (profiled, {wall * 1e3:.1f} ms wall): tier h2d "
            f"{split['h2d_copy']:.2f} ms, dequant kernel {split['dequant_kernel']:.2f} ms, "
            f"flash kernel {split['flash_kernel']:.3f} ms, other kernels "
            f"{split['other_kernels']:.2f} ms, device idle share "
            f"{split['device_idle_share']:.3f}")
    return split


# ----------------------------------------------------------------------
def _serve(eng, cfg, prompts, max_news, *, max_slots, on_engine=None,
           params=None, device=None, priorities=None, extras=None, **kw):
    """Serve ``prompts`` (with ``priorities``, default 0, and an
    encoder-decoder's per-request ``extras``) through a
    ContinuousEngine over ``eng``'s pool (``eng`` None: the plain plane
    over ``params`` on ``device``), on paged KV of 16-position pages
    unless ``kv_page`` says otherwise; returns (engine, tokens per
    request, emit step of every token, decode calls and active rows,
    admission chunks and encoder passes, with their seconds).
    ``on_engine`` is called with the engine before it serves."""
    from repro_torch.serving.engine import ContinuousEngine
    ce = ContinuousEngine(params, cfg, offload=eng, max_slots=max_slots,
                          eos_id=None, device=device, **{"kv_page": 16, **kw})
    if on_engine is not None:
        on_engine(ce)
    calls = {"decode": 0, "rows": 0, "chunks": 0, "encodes": 0,
             "decode_s": 0.0, "chunk_s": 0.0, "encode_s": 0.0}
    ex = ce._exec
    names = ("decode", "prefill_chunk", "prefill_chunk_row", "encode")
    saved = {n: ex.__dict__.get(n) for n in names}
    dec = ex.decode

    def timed(key, fn, *a, **kw):
        """``fn`` timed to its completion on the device (the engine reads
        each call's tokens back right after it anyway)."""
        t = time.perf_counter()
        out = fn(*a, **kw)
        if ce.device.type == "cuda":
            import torch
            torch.cuda.synchronize(ce.device)
        calls[key] += time.perf_counter() - t
        return out

    def counted_decode(state, tokens, pstate=None, active=None, **kw):
        calls["decode"] += 1  # a recurrent row's replay passes no active
        calls["rows"] += int(tokens.shape[0] if active is None else active.sum())
        return timed("decode_s", dec, state, tokens, pstate, active, **kw)

    def counted(fn):
        def chunk(*a):
            calls["chunks"] += 1
            return timed("chunk_s", fn, *a)
        return chunk

    def counted_encode(audio):
        calls["encodes"] += 1
        return timed("encode_s", encode, audio)

    encode = ex.encode
    ex.decode = counted_decode
    ex.prefill_chunk = counted(ex.prefill_chunk)
    ex.prefill_chunk_row = counted(ex.prefill_chunk_row)
    ex.encode = counted_encode
    steps = {}
    try:
        reqs = [ce.submit(p, m, priority=q, extras=e, on_token=lambda r, t: steps.setdefault(
            r.rid, []).append(ce.step_count))
            for p, m, q, e in zip(prompts, max_news, priorities or [0] * len(prompts),
                                  extras or [None] * len(prompts))]
        ce.run(max_steps=1000)
    finally:
        for n, fn in saved.items():
            if fn is None:
                ex.__dict__.pop(n, None)
            else:
                setattr(ex, n, fn)
    if not all(r.state == "finished" for r in reqs):
        fail("a served request never finished")
    return ce, [r.generated for r in reqs], [steps[r.rid] for r in reqs], calls


def phase_continuous_parity(dev):
    """tiny-moe continuous batching over the offloaded pool on paged KV,
    four requests through two slots, card against CPU: equal tokens, emit
    steps and offload counters."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.models import transformer as T
    cfg = get_config("tiny-moe")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 14)]
    news = (8, 5, 7, 4)
    runs = {}
    for where in ("cpu", dev):
        eng = OffloadEngine(_to(exec_params, where), cfg, spec, quantized=True,
                            store=store if where == "cpu" else _cpu_store_to(store, where),
                            device=where)
        ce, toks, steps, _ = _serve(eng, cfg, prompts, news, max_slots=2,
                                    slot_len=64)
        counters = {k: v for k, v in ce.stats().items() if k.startswith("offload_")}
        runs[str(where)] = (toks, steps, counters, ce._pstate.overflow_accesses)
    same = runs["cpu"] == runs[str(dev)]
    log(f"[continuous-parity] tiny-moe 4 requests / 2 slots, card vs cpu: equal "
        f"{same}; counters {runs[str(dev)][2]}, overflow accesses "
        f"{runs[str(dev)][3]}; tokens {runs[str(dev)][0]}")
    if not same:
        fail(f"tiny-moe continuous serving on the card differs from the CPU: "
             f"{runs[str(dev)]} vs {runs['cpu']}")


class _SlotCapture:
    """Keeps the inputs of the decode launches of the slot binding that
    read the farthest into a pool's overflow records (one per matrix:
    gate, up, down, in the order the MoE layer calls them), so that they
    can be checked and timed after the run.  The slot map is read from
    the pool state's host copy, so the capture adds no device read; it
    copies x and the slot map only when a launch reaches farther."""

    def __init__(self, ops):
        self.ops, self.fn, self.ce = ops, ops.dequant_matmul_slots, None
        self.calls, self.best = 0, [None] * 3

    def __call__(self, x, qt, slots):
        st = self.ce._pstate
        key = (int(st.slot_host[:slots.numel()].numpy().max()), slots.numel())
        i = self.calls % 3
        self.calls += 1
        if self.best[i] is None or key > self.best[i][0]:
            self.best[i] = (key, x.clone(), qt, slots.clone(),
                            st.pool.n_slots)
        return self.fn(x, qt, slots)

    @property
    def launches(self):  # the binding counts through its module's name
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __enter__(self):
        self.ops.dequant_matmul_slots = self
        return self

    def __exit__(self, *exc):
        self.ops.dequant_matmul_slots = self.fn


def _check_serving_slots(capture):
    """The slot binding on the captured serving inputs (x of the active
    rows, the layer's pool-and-overflow view, the slot map ``acquire``
    returned) against its plain version at the suite's ``KERNEL_RTOL``,
    and timed (CUDA events, flushed L2).  The bound reads each distinct
    record once."""
    import torch
    from repro_torch.benchmarks import kernels_bench as KB
    from repro_torch.kernels import dequant_matmul as DM, ref
    flush = KB.new_flush("cuda")
    fn = capture.fn
    record_bytes = capture.ce._pstate.pool.layout.record_bytes
    out = dict(ms=0.0, plain_ms=0.0, previous_ms=0.0, bytes=0, flops=0, err=0.0,
               rel=0.0, previous_err=0.0)
    for (max_index, rows), x, qt, slots, S in capture.best:
        gemv = DM.launch.routes["gemv"]
        y, yp = fn(x, qt, slots), ref.dequant_matmul_slots(x, qt, slots)
        route = "gemv" if DM.launch.routes["gemv"] == gemv + 1 else "fma"
        yprev = DM._launch_fma(x, qt, slots)  # the FMA kernel, the previous route
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        perr = (yprev - yp).abs().max().item()
        scale = yp.abs().max().item()
        if route != "gemv":
            fail(f"dequant_matmul_slots at serving shape took the {route} route")
        if (not (err <= KB.KERNEL_RTOL * scale) or not torch.isfinite(y).all()
                or not perr <= KB.KERNEL_RTOL * scale):
            fail(f"dequant_matmul_slots at serving shape ({rows} rows, slot "
                 f"index up to {max_index}): {err:.3g} (previous kernel "
                 f"{perr:.3g}) > {KB.KERNEL_RTOL} x {scale:.3g}")
        K, N = qt.shape[1:]
        distinct = len(set(slots.tolist()))
        out["ms"] += KB.event_ms(lambda: fn(x, qt, slots), 20, flush)
        out["previous_ms"] += KB.event_ms(lambda: DM._launch_fma(x, qt, slots), 20, flush)
        out["previous_err"] = max(out["previous_err"], perr)
        out["plain_ms"] += KB.event_ms(lambda: ref.dequant_matmul_slots(x, qt, slots),
                                     3, flush)
        out["bytes"] += (KB.stored_bytes(qt, distinct) + x.numel() * x.element_size()
                         + y.numel() * 4)
        out["flops"] += 2 * rows * K * N
        out["err"], out["rel"] = max(out["err"], err), max(out["rel"], err / scale)
        if max_index < S:
            fail("no serving decode launch read an overflow record")
        out.setdefault("rows_maxindex_distinct", []).append(
            (rows, max_index, distinct))
        out["max_offset_gib"] = max(out.get("max_offset_gib", 0.0),
                                    max_index * record_bytes / 2**30)
    out["bound_ms"], out["bound_by"] = KB.bound(out["bytes"], out["flops"])
    out["bound_share"] = out["bound_ms"] / out["ms"]
    log(f"[serve-kernel] dequant_matmul_slots at the serving run's shapes, "
        f"per MoE layer (3 matrices): {json.dumps(out)}")
    return out


def phase_serving(dev, eng, cfg):
    """mixtral-offload (8 of 32 layers) serving 8 requests through 4 slots
    on paged KV, greedy, FCFS: the slice's main path.  Every launch count
    is read around this run alone.  The slot binding's decode launch that
    read farthest into the overflow records is checked and timed after
    the run on the inputs it had."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    news = [SERVE_NEW] * SERVE_REQUESTS
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256)
    _serve(eng, cfg, prompts[:2], [3, 3], **kw)  # warm-up (allocator, handles)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    before = _routes()
    with _SlotCapture(ops) as capture:
        t0 = time.perf_counter()
        ce, toks, steps, calls = _serve(
            eng, cfg, prompts, news,
            on_engine=lambda e: setattr(capture, "ce", e), **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    launches = ops.launches()
    routes = _routes_since(before)
    L = eng.n_moe_layers
    expect = {"dequant_matmul": 0, "dequant_matmul_batched": 3 * L * calls["chunks"],
              "dequant_matmul_slots": 3 * L * calls["decode"], "flash_attention": 0,
              "ragged_attention": cfg.n_layers * (calls["decode"] + calls["chunks"])}
    st = ce._pstate
    hits, spec_hits, demand, spec = (int(c) for c in st.counts)
    counters_bytes = (demand + spec) * eng.expert_bytes
    n_tok = sum(len(t) for t in toks)
    report = {
        "requests": SERVE_REQUESTS, "prompt_lens": lens.tolist(),
        "max_new": SERVE_NEW, "slots": SERVE_SLOTS, "wall_s": wall,
        "tokens": n_tok, "tokens_per_s": n_tok / wall,
        "decode_tokens": calls["rows"], "decode_tokens_per_s": calls["rows"] / wall,
        "steps": ce.step_count, "decode_steps": calls["decode"],
        "admission_chunks": calls["chunks"],
        "mean_active_rows": calls["rows"] / max(1, calls["decode"]),
        "hits": hits, "spec_hits": spec_hits, "demand_loads": demand,
        "spec_loads": spec, "overflow_accesses": st.overflow_accesses,
        "bytes_h2d_issued": st.h2d_bytes, "bytes_h2d_counters": counters_bytes,
        "host_reads": st.host_reads,
        "launches": launches, "launches_expected": expect, "routes": routes,
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log(f"[serve] {json.dumps(report)}")
    served_by = ("dequant_matmul_batched", "dequant_matmul_slots", "ragged_attention")
    if launches != expect or min(launches[k] for k in served_by) < 1:
        fail(f"serving launches {launches} != expected {expect}")
    if (routes["dequant_gemv"] != expect["dequant_matmul_slots"] or routes["dequant_fma"]
            or routes["ragged_mma"] != expect["ragged_attention"] or routes["ragged_warp"]):
        fail(f"serving did not run the tensor-core kernels on every launch: {routes}")
    counters = {"hits": hits, "demand_loads": demand,
                "overflow_accesses": st.overflow_accesses, "bytes_h2d": st.h2d_bytes}
    log(f"[serve] counters {counters} beside the previous decode kernels' "
        f"{PREVIOUS_SERVE}: equal {counters == PREVIOUS_SERVE}")
    if counters != PREVIOUS_SERVE:
        def serve_counters(d):
            st = _serve(eng, cfg, prompts, news, on_engine=d.watch, **kw)[0]._pstate
            return {"hits": int(st.counts[0]), "demand_loads": int(st.counts[2]),
                    "overflow_accesses": st.overflow_accesses,
                    "bytes_h2d": st.h2d_bytes}
        _explain_difference("serve", serve_counters)
    if st.h2d_bytes != counters_bytes:
        fail(f"serving h2d bytes issued {st.h2d_bytes} != counters {counters_bytes}")
    if spec != 0:
        fail(f"{spec} speculative loads at batch {SERVE_SLOTS}")
    if any(len(t) != SERVE_NEW or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        fail("served requests returned malformed tokens")
    ce.kv.check_invariants()
    report["slots_kernel"] = _check_serving_slots(capture)
    # the profiler window: four rows decoding together
    from repro_torch.serving.engine import ContinuousEngine
    ce = ContinuousEngine(None, cfg, offload=eng, kv_page=16, eos_id=None, **kw)
    for p in prompts[:SERVE_SLOTS]:
        ce.submit(p, SERVE_NEW)
    for _ in range(3):  # admission step + two decode steps
        ce.step()
    torch.cuda.synchronize(dev)
    n_prof = 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            ce.step()
        torch.cuda.synchronize(dev)
    report["profile"] = _device_split(prof, n_prof, "serve-profile",
                                      "serve_decode_trace.json")
    return launches, report["slots_kernel"], toks


# ----------------------------------------------------------------------
# the continuous engine's KV layout x admission overlays of the reference's
# parity harness (tests/parity.py), copied
SERVE_VARIANTS = {"dense": dict(kv_page=None),
                  "dense_chunked": dict(kv_page=None, prefill_chunk=4),
                  "paged": dict(kv_page=16),
                  "paged_exact": dict(kv_page=16, ragged_bucket=False),
                  "paged_chunked": dict(kv_page=16, prefill_chunk=4)}
STATIC_DRIFT = 0.25  # static vs continuous token counts (the reference's
                     # serve_bench bound): EOS stops and the static
                     # prefill's capacity drops make them differ


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_serve_plain_parity(dev):
    """``tiny-moe`` (f32, seeded weights) served card against CPU: the
    plain ``ContinuousEngine`` on the five KV/admission overlays, the
    packed one on dense slots (and pages, for its counters) and
    ``ServeEngine.serve_batch`` on mixed lengths.  Equal tokens and emit
    steps card against CPU; on the card every plain continuous request
    equal to ``generate_plain``, and the packed dense-slot counters equal
    to the packed paged run's with the same admission.  Returns the card's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import (OffloadEngine, generate_plain,
                                                 quantize_for_offload)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request, ServeEngine
    t0 = time.perf_counter()
    cfg = get_config("tiny-moe")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 14)]
    news = (8, 5, 7, 4)
    runs, launches = {}, {}
    for where in ("cpu", dev):
        ops.reset_launches()
        p = _to(params, where)
        for name, kw in SERVE_VARIANTS.items():
            _, toks, steps, _ = _serve(None, cfg, prompts, news, max_slots=2,
                                       slot_len=64, params=p, device=where, **kw)
            runs[str(where), "plain", name] = (toks, steps)
        eng = OffloadEngine(_to(exec_params, where), cfg, spec, quantized=True,
                            store=store if where == "cpu" else _cpu_store_to(store, where),
                            device=where)
        for name in ("dense", "dense_chunked", "paged", "paged_chunked"):
            ce, toks, steps, _ = _serve(eng, cfg, prompts, news, max_slots=2,
                                        slot_len=64, **SERVE_VARIANTS[name])
            counters = {k: v for k, v in ce.stats().items()
                        if k.startswith("offload_")}
            runs[str(where), "packed", name] = (toks, steps, counters)
        out = ServeEngine(p, cfg, device=where).serve_batch(
            [Request(pr, m) for pr, m in zip(prompts, news)])
        runs[str(where), "static"] = [r.completed for r in out]
        if where != "cpu":
            launches = ops.launches()
    oracle = [generate_plain(_to(params, dev), cfg, pr[None], m,
                             device=dev)[0].tolist()
              for pr, m in zip(prompts, news)]
    card = {k[1:]: v for k, v in runs.items() if k[0] == str(dev)}
    host = {k[1:]: v for k, v in runs.items() if k[0] == "cpu"}
    unequal = sorted(" ".join(k) for k in card if card[k] != host[k])
    not_oracle = sorted(n for n in SERVE_VARIANTS if card["plain", n][0] != oracle)
    counters = {n: card["packed", n][2] for n in ("dense", "dense_chunked", "paged",
                                                   "paged_chunked")}
    same_counters = (counters["dense"] == counters["paged"]
                     and counters["dense_chunked"] == counters["paged_chunked"])
    log(f"[serve-plain-parity] tiny-moe 4 requests / 2 slots, card vs cpu: runs "
        f"differing {unequal}; plain runs != generate_plain {not_oracle}; packed "
        f"counters on dense slots == on pages (whole / chunked admission) "
        f"{same_counters}: {counters['dense']} / {counters['dense_chunked']}; "
        f"static tokens {card[('static',)]}; card launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    if unequal or not_oracle or not same_counters:
        fail("tiny-moe serving on the card: card and CPU differ, a plain run "
             "differs from generate_plain, or the packed counters differ by "
             "KV layout")
    return launches


def phase_serve_bench(dev):
    """The port's ``serve_bench.run(quick=True)`` on the card (``tiny-moe``,
    random weights): its scenarios assert their own parities.  Returns the
    launches."""
    from repro_torch.benchmarks import serve_bench
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launches()
    rows = serve_bench.run(quick=True, device=dev)
    launches = ops.launches()
    for r in rows:
        log(f"[serve-bench] {json.dumps(r)}")
    log(f"[serve-bench] launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


def _decode_syncs(eng, cfg, prompts, kw, steps=4):
    """Host synchronisations per batched decode step, counted by PyTorch's
    sync debug mode over ``steps`` decode-only steps of a fresh engine
    (after one decode step that is not counted), with the calls that
    made them."""
    import traceback
    import warnings
    import torch
    from repro_torch.serving.engine import ContinuousEngine
    ce = ContinuousEngine(kw.pop("params", None), cfg, offload=eng,
                          eos_id=None, **kw)
    for p in prompts:
        ce.submit(p, SERVE_NEW)
    while ce._admissions or ce.sched.has_waiting:
        ce.step()
    ce.step()
    torch.cuda.synchronize(ce.device)
    where, inside = [], [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            where.append(f"{Path(filename).name}:{lineno} from " + (
                f"{Path(frames[-1].filename).name}:{frames[-1].lineno}"
                if frames else "?"))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):  # only what the steps do is counted
                inside[0] = True
                ce.step()
                inside[0] = False
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return {"per_step": len(where) / steps, "where": sorted(set(where))}


def phase_serve_plain(dev, eng, cfg, dense):
    """mixtral-offload (the main phase's 8 layers, ``dense``: its store's
    records dequantized on the card, bf16) serving ``[serve]``'s 8
    requests through 4 slots on the plain plane: on pages of 16 (the
    ragged kernel) and on dense slot KV (flash on each admission chunk);
    ``ServeEngine.serve_batch`` in FCFS groups of 4 (the static baseline);
    and the packed ``[serve]`` engine on dense slot KV over the main pool
    (flash and the batched binding on admission, the slot binding in
    decode).  Each run's launches, routes and peak memory are read around
    it alone.  The plain paged, plain dense and packed paged token streams
    are held to the near-tie rule; static token counts within
    ``STATIC_DRIFT`` of the continuous ones.  Returns the summed
    launches."""
    import torch
    from repro_torch.benchmarks.serve_bench import run_static
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)  # [serve]'s workload
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    news = [SERVE_NEW] * SERVE_REQUESTS
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256)
    plain = dict(params=dense, device=dev)
    L = eng.n_moe_layers
    runs = {"plain paged": (None, dict(plain, kv_page=16)),
            "plain dense": (None, dict(plain, kv_page=None)),
            "packed dense": (eng, dict(kv_page=None))}
    total, reports = {}, {}

    def measure(run):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        before = _routes()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize(dev)
        return (out, time.perf_counter() - t, ops.launches(), _routes_since(before),
                torch.cuda.max_memory_allocated(dev) / 2**30)

    for label, (e, extra) in runs.items():
        _serve(e, cfg, prompts[:2], [3, 3], **kw, **extra)  # warm-up
        (ce, toks, steps, calls), wall, launches, routes, peak = measure(
            lambda: _serve(e, cfg, prompts, news, **kw, **extra))
        n_tok = sum(len(t) for t in toks)
        chunks, dec = calls["chunks"], calls["decode"]
        expect = {"dequant_matmul": 0, "dequant_matmul_batched": 0,
                  "dequant_matmul_slots": 0, "flash_attention": 0,
                  "ragged_attention": 0}
        if label == "plain paged":
            expect["ragged_attention"] = cfg.n_layers * (dec + chunks)
        else:
            expect["flash_attention"] = cfg.n_layers * chunks
        if e is not None:
            expect["dequant_matmul_batched"] = 3 * L * chunks
            expect["dequant_matmul_slots"] = 3 * L * dec
        report = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
                  "steps": ce.step_count, "decode_steps": dec,
                  "admission_chunks": chunks, "admission_s": calls["chunk_s"],
                  "decode_s": calls["decode_s"],
                  "decode_tokens_per_s": calls["rows"] / calls["decode_s"],
                  "mean_active_rows": calls["rows"] / max(1, dec),
                  "launches": launches, "launches_expected": expect,
                  "routes": {k: v for k, v in routes.items() if v},
                  "peak_device_gib": peak}
        report["host_syncs_per_decode_step"] = _decode_syncs(
            e, cfg, prompts[:SERVE_SLOTS], dict(kw, **extra))
        if e is not None:
            st = ce._pstate
            hits, spec_hits, demand, spec = (int(c) for c in st.counts)
            report.update(hits=hits, spec_hits=spec_hits, demand_loads=demand,
                          spec_loads=spec, overflow_accesses=st.overflow_accesses,
                          bytes_h2d_issued=st.h2d_bytes,
                          bytes_h2d_counters=(demand + spec) * eng.expert_bytes)
            if st.h2d_bytes != report["bytes_h2d_counters"] or spec:
                fail(f"[serve-plain] {label}: h2d bytes issued {st.h2d_bytes} != "
                     f"counters {report['bytes_h2d_counters']}, or {spec} "
                     f"speculative loads at batch {SERVE_SLOTS}")
        log(f"[serve-plain] {label}: {json.dumps(report)}")
        if e is None and report["host_syncs_per_decode_step"]["per_step"] != 1:
            fail(f"[serve-plain] {label}: a plain decode step must read back only "
                 f"its sampled tokens: {report['host_syncs_per_decode_step']}")
        if launches != expect:
            fail(f"[serve-plain] {label}: launches {launches} != expected {expect}")
        if (routes["ragged_mma"] != expect["ragged_attention"]
                or routes["dequant_gemv"] != expect["dequant_matmul_slots"]
                or routes["grouped_grouped"] != expect["dequant_matmul_batched"]):
            fail(f"[serve-plain] {label}: a launch left the tensor-core routes: "
                 f"{routes}")
        if any(len(t) != SERVE_NEW or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks):
            fail(f"[serve-plain] {label}: malformed tokens")
        reports[label] = (report, toks)
        _add(total, launches)
    static = ServeEngine(dense, cfg, device=dev)
    run_static(static, [(p, 3) for p in prompts[:2]], SERVE_SLOTS)  # warm-up
    workload = list(zip(prompts, news))
    n_static, wall, launches, routes, peak = measure(
        lambda: run_static(static, workload, SERVE_SLOTS))
    n_cont = sum(len(t) for t in reports["plain dense"][1])
    drift = abs(n_cont - n_static) / max(1, n_cont)
    log(f"[serve-plain] static (serve_batch, FCFS groups of {SERVE_SLOTS}): "
        + json.dumps({"wall_s": wall, "tokens": n_static,
                      "tokens_per_s": n_static / wall, "launches": launches,
                      "peak_device_gib": peak, "drift_vs_continuous": drift}))
    if not drift < STATIC_DRIFT or any(launches.values()):
        fail(f"[serve-plain] static: {n_static} tokens vs {n_cont} continuous "
             f"(limit {STATIC_DRIFT}), or a kernel launched: {launches}")
    traces = {
        "packed paged": _trace(lambda d: _serve(eng, cfg, prompts, news,
                                                on_engine=d.watch, **kw)),
        "plain paged": _trace(lambda d: _serve(None, cfg, prompts, news,
                                               on_engine=d.watch, **kw, **plain)),
        "plain dense": _trace(lambda d: _serve(None, cfg, prompts, news, kv_page=None,
                                               on_engine=d.watch, **kw, **plain))}
    for a, b in (("plain paged", "packed paged"), ("plain dense", "plain paged")):
        diff = _hold_to_near_tie(f"serve-plain] [{a} vs {b}", traces[a][0],
                                 traces[b][0], (a, b))
        if diff is None and traces[a][1][1] != traces[b][1][1]:
            fail(f"[serve-plain] {a} vs {b}: every decision equal but the "
                 f"tokens differ")
    log(f"[serve-plain] packed dense-slot tokens == packed paged "
        f"{reports['packed dense'][1] == traces['packed paged'][1][1]}; "
        f"{time.perf_counter() - t0:.1f} s")
    return total


def phase_planes(dev, eng, cfg):
    """The reference's ``offload_bench`` variants on the main phase's
    model, weights and store (``store=``, quantized once): ``pr2_sync``
    (``pipelined=False, vectorized=False``), ``vectorized`` and
    ``pipelined``, each prefilling the 64-token prompt (one chunk) and
    generating ``NEW_TOKENS`` greedily after a warm-up.  Decode tokens/s
    over the synchronised token loop, p50/p95 ms per token from the host
    clock at each token (each token is read back, a synchronisation),
    prefill s, counters, h2d bytes issued and the launch counts of every
    binding, set to 0 just before each variant's run.  Fails unless the
    three give equal tokens and counters, h2d bytes issued equal the
    counters, the 2-D dequant binding runs 3 x top_k per MoE layer per
    decode step on ``pr2_sync`` only (the slot binding 3 per MoE layer
    per step on the others) and every prefill chunk took the flash kernel
    in each.  Returns the reports by variant."""
    import torch
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import OffloadEngine
    from repro_torch.kernels import ops
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))
    L, K = eng.n_moe_layers, cfg.moe.top_k
    reports, ref = {}, None
    for name, flags in PLANES.items():
        e = OffloadEngine(eng.params, cfg, eng.spec, quantized=True,
                          store=eng.store, device=dev, **flags)
        e.generate(prompt[:, :8], 3)  # warm-up (allocator, library handles)
        torch.cuda.synchronize(dev)
        stamps = []
        ops.reset_launches()
        before = _routes()
        toks, stats = e.generate(prompt, NEW_TOKENS,
                                 on_step=lambda lg, r: stamps.append(time.perf_counter()))
        launches = ops.launches()
        routes = _routes_since(before)
        ps, t = e._last_pool_state, e.last_timing
        steps = t["decode_steps"]
        ms = np.diff(stamps) * 1e3
        pr2 = not flags["vectorized"]
        expect = {"dequant_matmul": 3 * K * L * steps if pr2 else 0,
                  "dequant_matmul_batched": 3 * L,
                  "dequant_matmul_slots": 0 if pr2 else 3 * L * steps,
                  "flash_attention": cfg.n_layers, "ragged_attention": 0}
        counters = {k: getattr(stats, k) for k in
                    ("hits", "spec_hits", "demand_loads", "spec_loads")}
        r = {"prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
             "decode_tok_s": steps / t["decode_s"],
             "p50_ms_per_token": float(np.percentile(ms, 50)),
             "p95_ms_per_token": float(np.percentile(ms, 95)),
             "counters": counters, "bytes_h2d_issued": ps.h2d_bytes,
             "bytes_h2d_counters": stats.bytes_h2d, "host_reads": ps.host_reads,
             "launches": launches, "launches_expected": expect, "routes": routes,
             "tokens": toks[0].tolist()}
        log(f"[planes] {name} {flags}: {json.dumps(r)}")
        if launches != expect or launches["flash_attention"] < 1:
            fail(f"planes {name}: launches {launches} != expected {expect}")
        decode_launches = expect["dequant_matmul"] + expect["dequant_matmul_slots"]
        if routes["dequant_gemv"] != decode_launches or routes["dequant_fma"]:
            fail(f"planes {name}: decode did not run the tensor-core GEMV: {routes}")
        if ps.h2d_bytes != stats.bytes_h2d:
            fail(f"planes {name}: h2d bytes issued {ps.h2d_bytes} != counters "
                 f"{stats.bytes_h2d}")
        if not EP.pool_coherent(e.store, ps):
            fail(f"planes {name}: pool incoherent")
        if ref is not None and (r["tokens"] != ref["tokens"]
                                or counters != ref["counters"]):
            fail(f"planes {name}: tokens or counters differ from "
                 f"{next(iter(reports))}: {r['tokens']} {counters} vs "
                 f"{ref['tokens']} {ref['counters']}")
        ref = ref or r
        reports[name] = r
        del e, ps
        torch.cuda.empty_cache()
    log(f"[planes] equal tokens and counters across {list(reports)}; decode "
        f"tok/s " + ", ".join(f"{n} {r['decode_tok_s']:.2f}" for n, r in reports.items()))
    return reports


# ----------------------------------------------------------------------
def _spec_totals(sm):
    return (sm.rounds, sm.proposed_total, sm.accepted_total, sm.emitted_total)


def _spec_delta(sm, before):
    rounds, prop, acc, emitted = (a - b for a, b in zip(_spec_totals(sm), before))
    return {"rounds": rounds, "proposed": prop, "accepted": acc,
            "emitted": emitted, "acceptance": acc / max(1, prop),
            "tokens_per_round": emitted / max(1, rounds)}


def phase_spec(dev, eng, cfg):
    """Draft-and-verify at full width: ``[main]``'s model, weights and
    store, the 64-token prompt, ``NEW_TOKENS`` greedy, on the three planes
    of ``[planes]``.  Per plane a non-speculative baseline, then a
    ``ReplayDraft`` at ``SPEC_K`` with every ``miss_every`` in
    ``SPEC_MISSES`` (0: acceptance 1.0) of the stream the speculative path
    itself produces (the baseline's, replayed again on the output until
    it reproduces itself: bf16 verify chunks round otherwise than C = 1
    decode).  Each run after
    a warm-up, launch counts set to 0 just before it.  Fails unless the
    tokens equal the baseline's or first differ at a near-tie (both runs
    traced by position, :class:`_PosTrace`), the h2d bytes issued equal
    ``(demand_loads + spec_loads) * per_expert_nbytes``, the launches are
    the expected ones on the tensor-core routes (every verify chunk's
    attention through flash, its experts through the GEMV at B = C x
    top_k rows, or the 2-D binding per (token, k) on ``pr2_sync``), the
    pool is coherent and, at acceptance 1.0 with equal tokens, the h2d
    bytes do not exceed the baseline's.  Returns the launches summed over
    the speculative runs."""
    import torch
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.draft import ReplayDraft
    from repro_torch.core.offload_engine import OffloadEngine
    from repro_torch.kernels import ops
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))
    L, K, S = eng.n_moe_layers, cfg.moe.top_k, PROMPT_LEN
    per_expert = EP.per_expert_nbytes(eng.store)
    total, summary = {}, []
    for name, flags in PLANES.items():
        e = OffloadEngine(eng.params, cfg, eng.spec, quantized=True,
                          store=eng.store, device=dev, **flags)
        warm, _ = e.generate(prompt[:, :8], 8)  # warm-up, both paths
        e.generate(prompt[:, :8], 8, draft=ReplayDraft(
            np.concatenate([prompt[0, :8], warm[0]]), vocab_size=cfg.vocab_size),
            num_draft_tokens=SPEC_K)
        torch.cuda.synchronize(dev)
        btoks, bstats = e.generate(prompt, NEW_TOKENS)
        bt = e.last_timing
        base_rate = bt["decode_steps"] / bt["decode_s"]
        base_trace = None
        # acceptance 1.0 needs the stream the verify chunks produce: in bf16
        # a C = 5 chunk rounds otherwise than C = 1 decode, a near-tie may
        # flip, and the baseline's stream then stops matching.  Replay the
        # speculative run's own output until it reproduces itself (each
        # pass fixes at least one more full round)
        stream, passes = btoks, []
        for _ in range(SPEC_FIXED_POINT):
            out, _ = e.generate(prompt, NEW_TOKENS, draft=ReplayDraft(
                np.concatenate([prompt[0], stream[0]]),
                vocab_size=cfg.vocab_size), num_draft_tokens=SPEC_K)
            passes.append(int((out != stream).sum()))
            if not passes[-1]:
                break
            stream = out
        ref = np.concatenate([prompt[0], stream[0]])
        log(f"[spec] {name} baseline: decode {base_rate:.2f} tok/s, h2d "
            f"{bstats.bytes_h2d / max(1, bstats.n_tokens):.0f} B per token, hit "
            f"ratio {bstats.hit_ratio:.4f}; replay stream: tokens changed by "
            f"each pass {passes} (0 last: a fixed point), "
            f"{int((stream != btoks).sum())} tokens off the baseline's")
        for miss in SPEC_MISSES:
            mk = lambda: ReplayDraft(ref, miss_every=miss, vocab_size=cfg.vocab_size)
            before_sm = _spec_totals(e.spec_metrics)
            ops.reset_launches()
            before = _routes()
            toks, stats = e.generate(prompt, NEW_TOKENS, draft=mk(),
                                     num_draft_tokens=SPEC_K)
            launches, routes = ops.launches(), _routes_since(before)
            t, ps = e.last_timing, e._last_pool_state
            sm = _spec_delta(e.spec_metrics, before_sm)
            plain_steps = stats.n_tokens - sm["emitted"]
            rows = sm["proposed"] + sm["rounds"] + plain_steps  # token rows decoded
            calls = sm["rounds"] + plain_steps
            pr2 = not flags["vectorized"]
            expect = {"dequant_matmul": 3 * K * L * rows if pr2 else 0,
                      "dequant_matmul_batched": 3 * L,
                      "dequant_matmul_slots": 0 if pr2 else 3 * L * calls,
                      "flash_attention": cfg.n_layers * (1 + sm["rounds"]),
                      "ragged_attention": 0}
            equal = bool((toks == btoks).all())
            r = {"miss_every": miss, "k": SPEC_K,
                 "decode_tok_s": t["decode_steps"] / t["decode_s"],
                 "baseline_decode_tok_s": base_rate,
                 "over_baseline": t["decode_steps"] / t["decode_s"] / base_rate,
                 **sm, "plain_steps": plain_steps,
                 "h2d_bytes_per_token": stats.bytes_h2d / max(1, stats.n_tokens),
                 "baseline_h2d_bytes_per_token":
                     bstats.bytes_h2d / max(1, bstats.n_tokens),
                 "bytes_h2d": stats.bytes_h2d, "bytes_h2d_issued": ps.h2d_bytes,
                 "baseline_bytes_h2d": bstats.bytes_h2d,
                 "hit_ratio": stats.hit_ratio,
                 "counters": {k: getattr(stats, k) for k in
                              ("hits", "spec_hits", "demand_loads", "spec_loads")},
                 "overflow_accesses": ps.overflow_accesses,
                 "launches": launches, "launches_expected": expect,
                 "routes": {k: v for k, v in routes.items() if v},
                 "tokens_equal_baseline": equal}
            log(f"[spec] {name} {json.dumps(r)}")
            if launches != expect:
                fail(f"spec {name} miss {miss}: launches {launches} != {expect}")
            decode = expect["dequant_matmul"] + expect["dequant_matmul_slots"]
            if (routes["dequant_gemv"] != decode or routes["dequant_fma"]
                    or routes["flash_wgmma"] != expect["flash_attention"]
                    or routes["flash_fma"]):
                fail(f"spec {name} miss {miss}: a launch left the tensor-core "
                     f"routes: {routes}")
            if not (ps.h2d_bytes == stats.bytes_h2d == (
                    stats.demand_loads + stats.spec_loads) * per_expert):
                fail(f"spec {name} miss {miss}: h2d bytes issued {ps.h2d_bytes} "
                     f"!= counters {stats.bytes_h2d}")
            if not EP.pool_coherent(e.store, ps):
                fail(f"spec {name} miss {miss}: pool incoherent")
            if not equal:
                if base_trace is None:
                    with _pos_trace_offload(e, S) as base_trace:
                        e.generate(prompt, NEW_TOKENS)
                with _pos_trace_offload(e, S) as tr:
                    again, _ = e.generate(prompt, NEW_TOKENS, draft=mk(),
                                          num_draft_tokens=SPEC_K)
                if not (again == toks).all():
                    fail(f"spec {name} miss {miss}: a repeated run differs")
                _hold_positions(f"spec] [{name} miss {miss}", tr, base_trace,
                                ("speculative", "baseline"), False)
            elif miss == 0 and stats.bytes_h2d > bstats.bytes_h2d:
                fail(f"spec {name}: acceptance-1.0 replay moved more h2d bytes "
                     f"({stats.bytes_h2d}) than the baseline ({bstats.bytes_h2d})")
            _add(total, launches)
            summary.append(f"{name}/miss {miss}: {r['decode_tok_s']:.2f} tok/s "
                           f"({r['over_baseline']:.2f}x), acceptance "
                           f"{sm['acceptance']:.3f}, {sm['tokens_per_round']:.2f} "
                           f"tokens/round, h2d/token {r['h2d_bytes_per_token']:.0f} "
                           f"vs {r['baseline_h2d_bytes_per_token']:.0f}")
        del e, ps
        torch.cuda.empty_cache()
    log("[spec] " + "; ".join(summary))
    return total


def _spec_draft(cfg, dev, *, bf16=False):
    """The serving draft: ``tiny-draft``'s config at the target's vocabulary
    (random weights, seed 7); with ``bf16`` in bfloat16 at head_dim 64,
    the flash kernel's tensor-core instance."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    dcfg = get_config("tiny-draft").replace(vocab_size=cfg.vocab_size)
    if bf16:
        dcfg = dcfg.replace(n_heads=4, n_kv_heads=2, head_dim=64,
                            dtype="bfloat16")
    return T.init_model(dcfg, seed=7, device=dev), dcfg


def phase_spec_serve(dev, eng, cfg, serve_toks):
    """``[serve]``'s 8 requests through 4 slots with a random ``tiny-draft``
    (the target's vocabulary, seed 7) at ``SPEC_K``, on the packed engine,
    on pages of 16 and on dense slot KV: tokens/s, steps, acceptance (near
    0: the draft is random), h2d bytes, launches by binding and route
    against the expected.  Tokens are held to ``[serve]``'s under the
    near-tie rule (both runs traced by position when they differ).
    Returns the launches summed over both runs."""
    import torch
    from repro_torch.kernels import ops
    dparams, dcfg = _spec_draft(cfg, dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    news = [SERVE_NEW] * SERVE_REQUESTS
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256, draft_params=dparams,
              draft_cfg=dcfg, num_draft_tokens=SPEC_K)
    L = eng.n_moe_layers
    total, base_trace = {}, None
    for layout, kv_page in (("paged", 16), ("dense", None)):
        _serve(eng, cfg, prompts[:2], [6, 6], kv_page=kv_page, **kw)  # warm-up
        torch.cuda.synchronize(dev)
        admits = [0]

        def count_admits(ce):
            fn = ce._draft_admit

            def admit(req):
                admits[0] += 1
                fn(req)
            ce._draft_admit = admit
        ops.reset_launches()
        before = _routes()
        t0 = time.perf_counter()
        ce, toks, _, calls = _serve(eng, cfg, prompts, news, kv_page=kv_page,
                                    on_engine=count_admits, **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches, routes = ops.launches(), _routes_since(before)
        sm = ce.spec_metrics
        st = ce._pstate
        n_tok = sum(len(t) for t in toks)
        flash_target = 0 if kv_page else cfg.n_layers * calls["chunks"]
        expect = {"dequant_matmul": 0,
                  "dequant_matmul_batched": 3 * L * calls["chunks"],
                  "dequant_matmul_slots": 3 * L * calls["decode"],
                  "flash_attention": flash_target + dcfg.n_layers * admits[0],
                  "ragged_attention": (cfg.n_layers * (calls["decode"] + calls["chunks"])
                                       if kv_page else 0)}
        equal = [list(t) for t in toks] == [list(t) for t in serve_toks]
        r = {"layout": layout, "wall_s": wall, "tokens": n_tok,
             "tokens_per_s": n_tok / wall, "steps": ce.step_count,
             "decode_calls": calls["decode"], "admission_chunks": calls["chunks"],
             "draft_admissions": admits[0], "rounds": sm.rounds,
             "proposed": sm.proposed_total, "accepted": sm.accepted_total,
             "acceptance": sm.acceptance_rate,
             "tokens_per_round_per_row": sm.emitted_total / max(1, sm.rounds),
             "bytes_h2d": st.h2d_bytes,
             "bytes_h2d_per_token": st.h2d_bytes / max(1, n_tok),
             "bytes_h2d_per_emitted": sm.bytes_h2d_per_accepted,
             "overflow_accesses": st.overflow_accesses,
             "launches": launches, "launches_expected": expect,
             "routes": {k: v for k, v in routes.items() if v},
             "tokens_equal_serve": equal}
        log(f"[spec-serve] {json.dumps(r)}")
        if launches != expect:
            fail(f"spec-serve {layout}: launches {launches} != {expect}")
        if (routes["dequant_gemv"] != expect["dequant_matmul_slots"]
                or routes["dequant_fma"] or routes["ragged_warp"]
                or routes["ragged_mma"] != expect["ragged_attention"]
                or routes["flash_wgmma"] != flash_target
                or routes["grouped_grouped"] != expect["dequant_matmul_batched"]):
            fail(f"spec-serve {layout}: a target launch left the tensor-core "
                 f"routes: {routes}")
        counters = (int(st.counts[2]) + int(st.counts[3])) * eng.expert_bytes
        if st.h2d_bytes != counters:
            fail(f"spec-serve {layout}: h2d bytes issued {st.h2d_bytes} != "
                 f"counters {counters}")
        if sm.rounds < 1 or any(len(t) != SERVE_NEW for t in toks):
            fail(f"spec-serve {layout}: no verify round ran or a request is short")
        ce.check_invariants()
        if not equal:
            if base_trace is None:
                base_trace = _traced_serve(eng, cfg, prompts, news,
                                           max_slots=SERVE_SLOTS,
                                           slot_len=256)[0]
            trace = _traced_serve(eng, cfg, prompts, news, kv_page=kv_page,
                                  **kw)[0]
            _hold_positions(f"spec-serve] [{layout}", trace, base_trace,
                            ("speculative", "serve"), False)
        _add(total, launches)
    return total


def phase_spec_parity(dev):
    """Draft-and-verify on ``tiny-moe`` (f32, seeded weights), card
    (kernels) against CPU (plain versions), exactly equal tokens, counters
    and speculation totals: ``OffloadEngine`` on the three packed planes
    and accounting with the dense ``tiny-draft`` (seed 7), a replay of the
    baseline stream and a replay missing every third proposal, at k =
    ``SPEC_PARITY_K``, plus the replay at k = 1; ``ContinuousEngine`` with
    the dense draft on the plain plane over the five KV overlays; and the
    packed continuous engine on dense slots, pages of 16 and chunked
    admission.  Returns the card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.draft import DenseDraft, ReplayDraft
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg, dcfg = get_config("tiny-moe"), get_config("tiny-draft")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    dparams = T.init_model(dcfg, seed=7, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    qdeq, _ = quantize_for_offload(params, cfg, spec, device="cpu")
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 9))
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 11, 3, 8)]
    news = (6, 4, 8, 5)
    k = SPEC_PARITY_K
    runs, launches = {}, {}
    for where in ("cpu", dev):
        ops.reset_launches()
        store_w = store if where == "cpu" else _cpu_store_to(store, where)
        dp = _to(dparams, where)
        engines = {n: OffloadEngine(_to(exec_params, where), cfg, spec,
                                    quantized=True, store=store_w, device=where,
                                    **PLANES[n]) for n in PLANES}
        engines["accounting"] = OffloadEngine(_to(qdeq, where), cfg, spec,
                                              device=where)
        ref = None
        for n, e in engines.items():
            base = e.generate(prompt, 12)[0]
            ref = ref if ref is not None else np.concatenate([prompt[0], base[0]])
            drafts = {"dense": (lambda: DenseDraft(dp, dcfg, device=where), k),
                      "replay": (lambda: ReplayDraft(ref, vocab_size=cfg.vocab_size), k),
                      "replay_miss3": (lambda: ReplayDraft(
                          ref, miss_every=3, vocab_size=cfg.vocab_size), k),
                      "replay_k1": (lambda: ReplayDraft(
                          ref, vocab_size=cfg.vocab_size), 1)}
            for dn, (mk, kk) in drafts.items():
                toks, st = e.generate(prompt, 12, draft=mk(), num_draft_tokens=kk)
                runs[str(where), "offload", n, dn] = (
                    toks[0].tolist(), base[0].tolist(), str(st))
            runs[str(where), "offload", n, "totals"] = _spec_totals(e.spec_metrics)
        p = _to(params, where)
        skw = dict(draft_params=dp, draft_cfg=dcfg, num_draft_tokens=k)
        for name, kw in SERVE_VARIANTS.items():
            ce, toks, steps, _ = _serve(None, cfg, prompts, news, max_slots=2,
                                        slot_len=64, params=p, device=where,
                                        **kw, **skw)
            ce.check_invariants()
            runs[str(where), "plain", name] = (toks, steps,
                                               _spec_totals(ce.spec_metrics))
        off = engines["pipelined"]
        for name, kw in (("dense", dict(kv_page=None)), ("paged", dict(kv_page=16)),
                         ("chunked", dict(kv_page=None, prefill_chunk=4))):
            ce, toks, steps, _ = _serve(off, cfg, prompts[:3], news[:3],
                                        max_slots=2, slot_len=48, **kw, **skw)
            ce.check_invariants()
            runs[str(where), "offloaded", name] = (
                toks, steps, _spec_totals(ce.spec_metrics),
                {k2: v for k2, v in ce.stats().items() if k2.startswith("offload_")})
        if where != "cpu":
            launches = ops.launches()
    card = {k[1:]: v for k, v in runs.items() if k[0] == str(dev)}
    host = {k[1:]: v for k, v in runs.items() if k[0] == "cpu"}
    unequal = sorted(" ".join(map(str, k)) for k in card if card[k] != host[k])
    not_greedy = sorted(" ".join(k) for k, v in card.items()
                        if k[0] == "offload" and k[-1] != "totals" and v[0] != v[1])
    log(f"[spec-parity] tiny-moe f32, {len(card)} runs card vs cpu: differing "
        f"{unequal}; speculative != greedy {not_greedy}; card launches "
        f"{launches}; {time.perf_counter() - t0:.1f} s")
    if unequal or not_greedy:
        fail("spec-parity: card and CPU differ, or a speculative run differs "
             "from greedy decode")
    return launches


# ----------------------------------------------------------------------
def phase_plain_parity(dev):
    """The plain plane on ``tiny-moe`` and ``tiny-draft`` (f32, seeded
    weights), card against CPU: equal ``generate_plain`` tokens.  On
    ``tiny-moe``, on the card: accounting mode over the dequantized model
    (``quantized=True, packed=False``) against ``generate_plain`` over the
    same weights (bitwise equal tokens) and against the packed engine
    (equal tokens, counters and ``usage``); sampled runs from a card
    generator seeded with 0 repeat; ``SamplerConfig("greedy")`` equals
    greedy; every top-k draw lies in its step's top k."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadEngine, generate_plain
    from repro_torch.models import transformer as T
    from repro_torch.serving.sampler import SamplerConfig
    for name in ("tiny-moe", "tiny-draft"):
        cfg = get_config(name)
        params = T.init_model(cfg, seed=0, device="cpu")
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
        a = generate_plain(params, cfg, prompt, 16, device="cpu")
        b = generate_plain(_to(params, dev), cfg, prompt, 16, device=dev)
        log(f"[plain-parity] {name} generate_plain card vs cpu: tokens equal "
            f"{bool((a == b).all())}: {b[0].tolist()}")
        if not (a == b).all():
            fail(f"{name}: generate_plain on the card differs from the CPU")
    cfg = get_config("tiny-moe")
    params = _to(T.init_model(cfg, seed=0, device="cpu"), dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
    acct = OffloadEngine(params, cfg, cfg.offload, quantized=True, packed=False,
                         device=dev)
    packed = OffloadEngine(params, cfg, cfg.offload, quantized=True, device=dev)
    ta, sa = acct.generate(prompt, 16)
    tp, sp = packed.generate(prompt, 16)
    plain = generate_plain(acct.params, cfg, prompt, 16, device=dev)
    fields = ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads")
    ca, cp = ({f: getattr(s_, f) for f in fields} for s_ in (sa, sp))
    usage = bool(np.array_equal(acct.usage.counts, packed.usage.counts))
    log(f"[plain-parity] tiny-moe on the card: accounting tokens == "
        f"generate_plain {bool((ta == plain).all())}, == packed "
        f"{bool((ta == tp).all())}; accounting counters {ca}, packed pool "
        f"{cp}; usage equal {usage}")
    if not (ta == plain).all() or not (ta == tp).all() or ca != cp or not usage:
        fail("tiny-moe accounting mode differs from generate_plain or the "
             "packed engine on the card")
    gen = lambda: torch.Generator(dev).manual_seed(0)
    for label, eng, greedy in (("accounting", acct, ta), ("packed", packed, tp)):
        x, y = (eng.generate(prompt, 16, greedy=False, rng=gen())[0]
                for _ in range(2))
        g = eng.generate(prompt, 16, sampler=SamplerConfig("greedy"))[0]
        steps = []
        k = eng.generate(prompt, 16, rng=gen(), sampler=SamplerConfig("topk", top_k=4),
                         on_step=lambda lg, r: steps.append(lg[0]))[0]
        in_topk = all(int(t) in torch.topk(lg, 4).indices.tolist()
                      for t, lg in zip(k[0], steps))
        log(f"[plain-parity] {label} sampled twice from seed 0: equal "
            f"{bool((x == y).all())} {x[0].tolist()}; SamplerConfig('greedy') "
            f"== greedy {bool((g == greedy).all())}; top-4 draws in their "
            f"step's top 4 {in_topk}")
        if not ((x == y).all() and (g == greedy).all() and in_topk):
            fail(f"tiny-moe {label}: sampling on the card")


def phase_accounting(dev, eng, cfg, prompt, main_run):
    """The dense-resident oracle of ``[main]``: the main store's records
    dequantized on the card layer by layer into dense bf16 experts beside
    ``[main]``'s executable weights (no second quantization), generating
    ``[main]``'s 32 tokens in accounting mode (the plain plane, the
    prompt's one chunk through the flash kernel).  Its launch counts are
    read around that run alone.  Tokens and PyLRU replay counters are
    compared with ``[main]``'s packed run; the two runs' decisions are
    then traced and held to the near-tie rule.  Returns the launches and
    the dense weights (``[serve-plain]`` serves them, then frees them)."""
    import torch
    from repro_torch.core.offload_engine import OffloadEngine, dense_from_store
    from repro_torch.kernels import ops
    toks_main, stats_main = main_run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dense = dense_from_store(eng.params, cfg, eng.store, dev)
    acct = OffloadEngine(dense, cfg, eng.spec, device=dev)  # quantized=False
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    acct.generate(prompt[:, :8], 3)  # warm-up (allocator, library handles)
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    before = _routes()
    toks, stats = acct.generate(prompt, NEW_TOKENS)
    launches = ops.launches()
    routes = _routes_since(before)
    t = acct.last_timing
    fields = ("hits", "spec_hits", "demand_loads", "spec_loads")
    counters = {f: getattr(stats, f) for f in fields}
    counters_main = {f: getattr(stats_main, f) for f in fields}
    expect = {"dequant_matmul": 0, "dequant_matmul_batched": 0,
              "dequant_matmul_slots": 0, "flash_attention": cfg.n_layers,
              "ragged_attention": 0}
    dense_gib = sum(a.numel() * a.element_size() for lp in dense["layers"]
                    for a in lp["moe"]["experts"].values()) / 2**30
    report = {
        "oracle_prefill_s": t["prefill_s"],
        "oracle_decode_tok_s": t["decode_steps"] / t["decode_s"],
        "build_s": build_s, "dense_expert_gib": dense_gib,
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": launches, "launches_expected": expect, "routes": routes,
        "tokens_equal_main": bool((toks == toks_main).all()),
        "counters": counters, "counters_main": counters_main,
        "tokens": toks[0].tolist()}
    log(f"[accounting] {cfg.name} {cfg.n_layers} layers, dense-resident oracle "
        f"on the card (times are the oracle's, not an offload result): "
        f"{json.dumps(report)}")
    if launches != expect or routes["flash_wgmma"] != cfg.n_layers:
        fail(f"accounting launches {launches} (routes {routes}) != expected {expect}")
    if toks.shape != (1, NEW_TOKENS) or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        fail(f"accounting: bad tokens {toks}")
    packed, _ = _trace(lambda d: d.watch(eng).generate(prompt, NEW_TOKENS))
    oracle, _ = _trace(lambda d: d.watch(acct).generate(prompt, NEW_TOKENS))
    diff = _hold_to_near_tie("accounting", packed, oracle,
                             ("packed [main]", "dense oracle"))
    if diff is None and (counters != counters_main or not (toks == toks_main).all()):
        fail(f"accounting: every decision equal but tokens or counters differ: "
             f"{counters} vs {counters_main}")
    del acct
    torch.cuda.empty_cache()
    return launches, dense


def phase_bf16_parity(dev):
    """``tiny-moe`` at 4 heads over 2 KV heads (head_dim 64) in bf16, card
    (kernels) against CPU (plain versions): packed ``pipelined`` batch 1
    (16 tokens) and ``ContinuousEngine`` (4 requests through 2 slots,
    pages of 16), each also speculative (:func:`_bf16_spec`).  Each card
    run must take the tensor-core routes on every launch; card and CPU are
    held to the near-tie rule."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = get_config("tiny-moe").replace(n_heads=4, n_kv_heads=2, head_dim=64,
                                         dtype="bfloat16")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 14)]
    news = (8, 5, 7, 4)
    engines = {"cpu": OffloadEngine(exec_params, cfg, spec, quantized=True,
                                    store=store, device="cpu"),
               "card": OffloadEngine(_to(exec_params, dev), cfg, spec,
                                     quantized=True,
                                     store=_cpu_store_to(store, dev), device=dev)}
    cases = {
        "batch-1": lambda d, e: d.watch(e).generate(prompt, 16)[0],
        "continuous": lambda d, e: _serve(e, cfg, prompts, news, max_slots=2,
                                          slot_len=64, on_engine=d.watch)[1]}
    for case, run in cases.items():
        traces = {}
        for where, eng in engines.items():
            ops.reset_launches()
            before = _routes()
            traces[where] = _trace(lambda d: run(d, eng))
            launches, routes = ops.launches(), _routes_since(before)
        toks = {w: tr[1] for w, tr in traces.items()}
        equal = str(toks["cpu"]) == str(toks["card"])
        log(f"[bf16-parity] {case}: card launches {launches}, routes {routes}; "
            f"tokens equal {equal}")
        tc = {"dequant_gemv": launches["dequant_matmul_slots"],
              "grouped_grouped": launches["dequant_matmul_batched"],
              "flash_wgmma": launches["flash_attention"],
              "ragged_mma": launches["ragged_attention"]}
        other = ("dequant_fma", "grouped_fma", "flash_fma", "ragged_warp")
        used = ("dequant_gemv", "grouped_grouped") + (
            ("flash_wgmma",) if case == "batch-1" else ("ragged_mma",))
        if (any(routes[k] != n for k, n in tc.items()) or any(routes[k] for k in other)
                or any(routes[k] < 1 for k in used)):
            fail(f"bf16 {case}: a launch left the tensor-core routes: {routes}")
        diff = _hold_to_near_tie(f"bf16-parity] [{case}", traces["card"][0],
                                 traces["cpu"][0], ("card", "cpu"))
        if diff is None and not equal:
            fail(f"bf16 {case}: every decision equal but the tokens differ")
        if case == "batch-1":
            stream = np.concatenate([prompt[0], toks["cpu"][0]])
    _bf16_spec(dev, cfg, engines, prompt, stream, prompts, news)


def _bf16_spec(dev, cfg, engines, prompt, stream, prompts, news):
    """``[bf16-parity]``'s two cases as draft-and-verify, card against CPU:
    batch 1 with a replay of the CPU's stream missing every third proposal
    (k = ``SPEC_PARITY_K``: flash on ``wgmma`` at Sq = C, the GEMV at C x
    top_k rows), and the continuous engine on pages with a random bf16
    ``tiny-draft`` at head_dim 64 (``ragged_mma`` over B x C rows, the
    draft's prefill on flash ``wgmma``).  Every card launch on the
    tensor-core routes; card and CPU held to the near-tie rule by
    position (:class:`_PosTrace`)."""
    from repro_torch.core.draft import ReplayDraft
    from repro_torch.kernels import ops
    k = SPEC_PARITY_K
    drafts = {w: _spec_draft(cfg, "cpu" if w == "cpu" else dev, bf16=True)
              for w in engines}

    def batch1(where, e):
        with _pos_trace_offload(e, prompt.shape[1]) as tr:
            toks = e.generate(prompt, 16, draft=ReplayDraft(
                stream, miss_every=3, vocab_size=cfg.vocab_size),
                num_draft_tokens=k)[0]
        return tr, toks[0].tolist(), e.spec_metrics

    def continuous(where, e):
        tr, (ce, toks, _, _) = _traced_serve(
            e, cfg, prompts, news, max_slots=2, slot_len=64,
            draft_params=drafts[where][0], draft_cfg=drafts[where][1],
            num_draft_tokens=k)
        return tr, toks, ce.spec_metrics

    for case, run in (("batch-1 speculative", batch1),
                      ("continuous speculative", continuous)):
        out = {}
        for where, e in engines.items():
            ops.reset_launches()
            before = _routes()
            out[where] = run(where, e)
            launches, routes = ops.launches(), _routes_since(before)
        equal = out["cpu"][1] == out["card"][1]
        sm = out["card"][2]
        log(f"[bf16-parity] {case}: card launches {launches}, routes "
            f"{ {k2: v for k2, v in routes.items() if v} }; tokens equal "
            f"{equal}; card rounds {sm.rounds}, acceptance "
            f"{sm.acceptance_rate:.3f}")
        used = ("dequant_gemv", "grouped_grouped", "flash_wgmma") + (
            ("ragged_mma",) if case.startswith("continuous") else ())
        tc = {"dequant_gemv": launches["dequant_matmul_slots"],
              "grouped_grouped": launches["dequant_matmul_batched"],
              "flash_wgmma": launches["flash_attention"],
              "ragged_mma": launches["ragged_attention"]}
        other = ("dequant_fma", "grouped_fma", "flash_fma", "ragged_warp")
        if (any(routes[k2] != n for k2, n in tc.items())
                or any(routes[k2] for k2 in other)
                or any(routes[k2] < 1 for k2 in used) or sm.rounds < 1):
            fail(f"bf16 {case}: a launch left the tensor-core routes or no "
                 f"verify round ran: {routes}")
        _hold_positions(f"bf16-parity] [{case}", out["card"][0], out["cpu"][0],
                        ("card", "cpu"), equal)


# ----------------------------------------------------------------------
def phase_train(dev):
    """``tiny-moe`` (f32, full size) trained with the measurement recipe:
    card against CPU for ``TRAIN_PARITY_STEPS`` steps from the same
    CPU-made weights and batches, then the full recipe on the card, the
    checkpoint saved and restored.  Returns the trained parameters."""
    import hashlib
    import itertools
    import torch
    from repro_torch.benchmarks import common
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O, trainer
    cfg = get_config("tiny-moe")
    ds = common.recipe_dataset()
    corpus = np.concatenate([ds.train_bytes, ds.eval_bytes])
    log(f"[train] corpus: {corpus.size} bytes from the Python standard "
        f"library, md5 {hashlib.md5(corpus.astype(np.int32).tobytes()).hexdigest()} "
        f"(int32 tokens); {T.count_params_analytic(cfg)} parameters")
    init = T.init_model(cfg, seed=0, device="cpu")
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=30,
                            total_steps=common.TRAIN_STEPS)
    step = trainer.make_train_step(cfg, opt)
    batches = list(itertools.islice(ds.batches(), TRAIN_PARITY_STEPS))
    keys = ("loss", "ce", "load_balance", "grad_norm")
    runs = {}
    for where in ("cpu", dev):
        p = _to(init, where)
        st = O.init_opt_state(p)
        hist = []
        for b in batches:
            p, st, m = step(p, st, trainer.to_device(b, where))
            hist.append({k: float(m[k]) for k in keys})
        runs[str(where)] = hist
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                for a, b in zip(runs["cpu"], runs[str(dev)]) for k in keys)
    log(f"[train] card vs cpu, {TRAIN_PARITY_STEPS} steps from the same "
        f"weights: card {json.dumps(runs[str(dev)])}; cpu "
        f"{json.dumps(runs['cpu'])}; max relative difference {worst:.3g} "
        f"(limit {TRAIN_RTOL})")
    if not worst <= TRAIN_RTOL:
        fail(f"tiny-moe training on the card differs from the CPU: {worst}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, cfg, hist = common.train_tiny_moe(common.TRAIN_STEPS, dev,
                                              log_every=1, log=lambda _: None)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = np.diff([0.0] + [h["wall_s"] for h in hist]) * 1e3
    step_ms = float(np.median(ms[10:]))
    eval_b = list(ds.eval_batches())
    ce = trainer.eval_ce(params, cfg, eval_b)
    curve = {h["step"]: round(h["loss"], 4) for h in hist
             if h["step"] % 20 == 0 or h["step"] == len(hist) - 1}
    report = {"steps": len(hist), "loss_curve": curve,
              "final_loss": hist[-1]["loss"], "final_ce": hist[-1]["ce"],
              "eval_ce": ce, "wall_s": wall, "ms_per_step": step_ms,
              "train_tokens_per_s": common.BATCH * common.SEQ_LEN / (step_ms / 1e3),
              "peak_device_gib": peak}
    log(f"[train] {json.dumps(report)}")
    if not (np.isfinite(hist[-1]["loss"]) and hist[-1]["loss"] < hist[0]["loss"]):
        fail(f"training did not lower the loss: {curve}")
    _profile_train(step, params, batches, dev)
    path = common.checkpoint_path(common.TRAIN_STEPS)
    C.save(str(path), params, cfg, meta={"steps": common.TRAIN_STEPS,
                                         "final_loss": hist[-1]["loss"]})
    common.trace_path(common.TRACE_TOKENS).unlink(missing_ok=True)
    restored = C.restore(str(path), cfg, dev)
    ce2 = trainer.eval_ce(restored, cfg, eval_b)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(restored)))
    log(f"[train] checkpoint {path.name} restored: weights equal {same}, "
        f"eval ce {ce2} vs {ce}")
    if not same or ce2 != ce:
        fail("the restored checkpoint differs from the trained weights")
    return params


def _profile_train(step, params, batches, dev):
    """Where a training step's time goes: the parity phase's batches as
    further steps from the trained weights (results discarded), under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import optimizer as O, trainer
    bs = [trainer.to_device(b, dev) for b in batches]
    st = O.init_opt_state(params)
    step(params, st, bs[0])  # warm (allocator)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p = params
        for b in bs:
            p, st, m = step(p, st, b)
            float(m["loss"])
        torch.cuda.synchronize(dev)
    return _device_split(prof, len(bs), "train-profile", "train_trace.json")


def _leaves(tree):
    from repro_torch.quant.hqq import tree_leaves
    return tree_leaves(tree)


def phase_paper(dev, eng, cfg, main_report, planes, decode_split, kern):
    """The paper's measurements on the trained checkpoint of ``[train]``
    (the port's ``benchmarks`` modules on the card), the trained offload
    bench held against the CPU, and the cost model's H100 row against
    ``[main]``/``[planes]``.  Returns the launches of the phase."""
    from repro_torch.benchmarks import (common, fig2_lru, fig2_spec,
                                        offload_bench, table1_quant,
                                        table2_speed)
    from repro_torch.core import cost_model as CM
    from repro_torch.core.offload_engine import OffloadStats
    from repro_torch.kernels import ops
    ops.reset_launches()
    lru = {r["name"]: r["hit_ratio"] for r in fig2_lru.run(device=dev)
           if "hit_ratio" in r}
    log(f"[paper] fig2_lru hit ratio (trained tiny-moe, "
        f"{common.TRACE_TOKENS}-token trace): {json.dumps(lru)}")
    spec = {(r["lookahead"], r["n_fetch"]): r["recall"]
            for r in fig2_spec.run(device=dev) if "recall" in r}
    log("[paper] fig2_spec recall by lookahead, fetched 1/2/3/4/6/8: " + "; ".join(
        f"ahead {j}: " + " ".join(f"{spec[(j, n)]:.4f}" for n in (1, 2, 3, 4, 6, 8))
        for j in sorted({j for j, _ in spec})))
    t1 = [r for r in table1_quant.run(device=dev) if "eval_ce" in r]
    log("[paper] table1_quant (attn bits, expert bits: eval ce, Mixtral GB): "
        + "; ".join(f"{r['attn_bits']}/{r['expert_bits']}: {r['eval_ce']:.4f}, "
                    f"{r['mixtral_proj_gb']:.2f}" for r in t1))
    t2 = table2_speed.run(device=dev)
    log("[paper] table2_speed (Mixtral-8x7B, cost model, row h100): "
        + "; ".join(f"{r['name']}: {r['derived']}" for r in t2))
    card = offload_bench.run(trained=True, device=dev)
    launches = ops.launches()
    cpu = offload_bench.run(trained=True, device="cpu")
    for a, b in zip(card, cpu):
        if a["variant"] == "summary":
            continue
        log(f"[paper] offload_bench --trained {a['variant']}: {json.dumps(a)}")
        if a["tokens"] != b["tokens"] or a["counters"] != b["counters"]:
            fail(f"trained offload bench {a['variant']}: card {a['tokens']} "
                 f"{a['counters']} vs cpu {b['tokens']} {b['counters']}")
    log(f"[paper] trained offload bench: tokens equal to generate_plain and "
        f"to the CPU's on the three planes, counters equal; kernel launches "
        f"{launches}")

    # the cost model's H100 row against the measured batch-1 decodes
    held = CM.HARDWARE["h100"]
    bits, abits = eng.spec.expert_bits, eng.spec.attn_bits
    steps = NEW_TOKENS - 1
    stats = lambda c: OffloadStats(steps, **c, expert_bytes=eng.expert_bytes)
    main_tok_s = float(np.median(main_report["decode_tok_s_runs"]))
    main_counters = {k: v for k, v in main_report["stats"].items()
                     if k != "n_tokens"}
    fields = {
        "pcie_gbps": main_report["h2d_probe_gb_s"],
        "mem_eff": kern["dequant_matmul_slots"]["bound_ms"] / kern["dequant_matmul_slots"]["ms"],
        "copy_latency_s": main_report["copy_latency_probe_s"]}
    fit = None
    if decode_split is not None:
        kernel_s = (1 - decode_split["compute_idle_share"]) * decode_split["per_step_ms"] / 1e3
        measured_row = CM.Hardware(held.name, fields["pcie_gbps"], held.mem_bw_gbps,
                                   fields["mem_eff"], fields["copy_latency_s"],
                                   0.0, held.vram_gb)
        fit = CM.fit_overheads(cfg, measured_row,
                               stats(main_counters).per_token(),
                               bits, abits, main_tok_s, kernel_s)
        fields.update(kernel_s_per_token=kernel_s,
                      layer_overhead_s=fit.layer_overhead_s,
                      sw_overhead_s=fit.sw_overhead_s)
    log(f"[paper] cost model, this run's measurements for the h100 row "
        f"(fit to [main] pipelined at {main_tok_s:.2f} tok/s, median of "
        f"{main_report['decode_tok_s_runs']}): {json.dumps(fields)}; held in "
        f"cost_model.HARDWARE: {held}")
    rows = {"pipelined (fitted)": (main_counters, main_tok_s)}
    rows.update({f"{n} (not fitted)": (planes[n]["counters"], planes[n]["decode_tok_s"])
                 for n in ("pr2_sync", "vectorized")})
    for name, (counters, tok_s) in rows.items():
        est = eng.throughput_estimate(stats(counters), "h100")
        log(f"[paper] throughput_estimate {cfg.name} {cfg.n_layers} layers, "
            f"{name}: {est:.2f} tok/s estimated vs {tok_s:.2f} measured "
            f"(ratio {est / tok_s:.3f})")
    return launches


# ----------------------------------------------------------------------
# prefix cache, host swap with preemption, the fault plane (item 5)
def _counted_exec(ce, calls):
    """Count ``ce``'s decode calls and admission chunks into ``calls``."""
    ex = ce._exec
    for name in ("decode", "prefill_chunk_row"):
        fn = getattr(ex, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(ex, name, counted)


def _uncount_exec(ex):
    for name in ("decode", "prefill_chunk_row"):
        ex.__dict__.pop(name, None)


def phase_prefix(dev, eng, cfg):
    """``[main]``'s model (packed, 8 layers) serving the reference's full
    ``prefix_reuse`` workload: a 160-token system prompt, tails 8/12/10/
    14/9, 8 new tokens each, one slot, pages of 16, chunks of 16, a cache
    of 12 pages, one request at a time; cold (no cache) then hit.  Time to
    first token of the requests after the first, prefills skipped, hit
    tokens, the prefill tier's h2d bytes, launches by binding and route;
    the hit run's tokens must equal the cold run's (the chunk boundaries
    coincide, so the KV it adopts is the KV a cold prefill computes)."""
    import torch
    from repro_torch.benchmarks import serve_bench
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    prompts, page, sys_pages, max_new = serve_bench.prefix_reuse_workload(cfg)
    tier = eng._exec.prefill_tier
    runs, total = {}, {}
    for name, cache in (("cold", 0), ("hit", sys_pages + 2)):
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        before, h2d0 = _routes(), tier.h2d_bytes
        t0 = time.perf_counter()
        ttft, toks, ce = serve_bench.drive_prefix_reuse(
            None, cfg, prompts, page=page, sys_pages=sys_pages,
            max_new=max_new, cache_pages=cache, offload=eng)
        torch.cuda.synchronize(dev)
        launches = ops.launches()
        s = ce.stats()
        runs[name] = {
            "wall_s": time.perf_counter() - t0, "ttft_ms": ttft,
            "ttft_ms_median_follow_ups": float(np.median(ttft[1:])),
            "prefills_skipped": ce._prefills_skipped,
            "hit_tokens": ce._prefix_hit_tokens,
            "prefill_tier_h2d_bytes": tier.h2d_bytes - h2d0,
            "decode_h2d_bytes": s["offload_bytes_h2d"],
            "launches": launches,
            "routes": {k: v for k, v in _routes_since(before).items() if v},
            "tokens": toks}
        ce.check_invariants()
        _add(total, launches)
        log(f"[prefix] {name}: {json.dumps({k: v for k, v in runs[name].items() if k != 'tokens'}, default=int)}")
    cold, hit = runs["cold"], runs["hit"]
    ratio = cold["ttft_ms_median_follow_ups"] / hit["ttft_ms_median_follow_ups"]
    diff = next(((i, j) for i, (a, b) in enumerate(zip(cold["tokens"], hit["tokens"]))
                 for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    log(f"[prefix] {cfg.name} {cfg.n_layers} layers, system prompt "
        f"{page * sys_pages}: TTFT cold {cold['ttft_ms_median_follow_ups']:.1f} ms -> "
        f"hit {hit['ttft_ms_median_follow_ups']:.1f} ms ({ratio:.2f}x); prefill-tier "
        f"h2d {cold['prefill_tier_h2d_bytes']} -> {hit['prefill_tier_h2d_bytes']} B "
        f"({cold['prefill_tier_h2d_bytes'] / max(1, hit['prefill_tier_h2d_bytes']):.2f}x); "
        f"prefills skipped {hit['prefills_skipped']}, hit tokens {hit['hit_tokens']}; "
        f"hit tokens == cold tokens {diff is None}"
        + ("" if diff is None else f", first difference request {diff[0]} "
           f"token {diff[1]}") + f"; {time.perf_counter() - t_phase:.1f} s")
    if diff is not None:
        fail(f"prefix hits changed the tokens (request {diff[0]}, token {diff[1]})")
    if hit["prefills_skipped"] != len(prompts) - 1 or \
            hit["hit_tokens"] != (len(prompts) - 1) * page * sys_pages:
        fail(f"prefix: expected {len(prompts) - 1} hits of {page * sys_pages} tokens")
    for r in runs.values():
        if r["launches"]["ragged_attention"] != r["routes"].get("ragged_mma", 0) or \
                r["routes"].get("ragged_warp"):
            fail(f"prefix: a paged attention launch left ragged_mma: {r['routes']}")
    return total


def phase_preempt(dev, eng, cfg, serve_toks):
    """``[serve]``'s 8 requests (24 new tokens, priorities ``i % 2``)
    through 4 slots on pages of 16 over a pool of one worst case plus one
    page: stalling admission, preemption with a host pool of twice the
    pool, and preemption with none (every resume recomputes).  Tokens/s,
    preemptions / resumes / recomputes, swap bytes and the d2h / h2d GB/s
    of the swaps (each timed alone between synchronisations); every
    restored page's kp/vp/ppos bytes equal to what was gathered; tokens
    held to the stall run's (and it to ``[serve]``'s) by request and
    position under the near-tie rule; the pool empty at teardown."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import kv_manager as KV
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    news = [SERVE_NEW] * SERVE_REQUESTS
    pri = [i % 2 for i in range(SERVE_REQUESTS)]
    pool_pages = -(-(max(lens) + SERVE_NEW) // 16) + 1
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256, kv_page=16,
              kv_pages_total=pool_pages, priorities=pri)
    swaps = {"out_s": 0.0, "out_bytes": 0, "in_s": 0.0, "in_bytes": 0,
             "round_trips": 0}
    orig_out, orig_in = KV.PagedKVManager.swap_out, KV.PagedKVManager.swap_in

    def gathered(kv, pids):
        idx = torch.as_tensor(pids, device=kv.device)
        return {n: torch.stack([b["kv"][n][idx] for b in kv.state["layers"]]).cpu()
                for n in ("kp", "vp", "ppos")}

    def swap_out(kv, slot):
        torch.cuda.synchronize(dev)
        want = gathered(kv, kv.pool.owned[slot])
        t0 = time.perf_counter()
        blob = orig_out(kv, slot)
        torch.cuda.synchronize(dev)
        if blob is not None:
            swaps["out_s"] += time.perf_counter() - t0
            swaps["out_bytes"] += blob["n_pages"] * kv.page_nbytes()
            if any(not torch.equal(blob["data"][n], want[n]) for n in want):
                fail("preempt: a staged blob differs from the pages gathered")
        return blob

    def swap_in(kv, owner, blob, reserve):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        slot = orig_in(kv, owner, blob, reserve)
        torch.cuda.synchronize(dev)
        swaps["in_s"] += time.perf_counter() - t0
        swaps["in_bytes"] += blob["n_pages"] * kv.page_nbytes()
        got = gathered(kv, kv.pool.owned[slot])
        if any(not torch.equal(got[n], blob["data"][n]) for n in got):
            fail("preempt: the restored pages differ from the staged blob")
        swaps["round_trips"] += 1
        return slot

    KV.PagedKVManager.swap_out, KV.PagedKVManager.swap_in = swap_out, swap_in
    runs, total = {}, {}
    try:
        for name, extra in (("stall", {}),
                            ("swap", dict(preemption=True,
                                          kv_host_pages=2 * pool_pages)),
                            ("recompute", dict(preemption=True, kv_host_pages=0))):
            torch.cuda.synchronize(dev)
            ops.reset_launches()
            before = _routes()
            t0 = time.perf_counter()
            ce, toks, _, calls = _serve(eng, cfg, prompts, news, **kw, **extra)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = ops.launches()
            s = ce.stats()
            n_tok = sum(len(t) for t in toks)
            r = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                 "steps": ce.step_count, "decode_calls": calls["decode"],
                 "admission_chunks": calls["chunks"],
                 "mean_active_rows": calls["rows"] / max(1, calls["decode"]),
                 "preemptions": ce.sched.preemptions, "resumes": ce.sched.resumes,
                 "recomputes": ce._recomputes, "host": ce.kv.host_stats(),
                 "peak_pages_committed": s["kv_pages_peak_committed"],
                 "bytes_h2d": s["offload_bytes_h2d"], "launches": launches,
                 "routes": {k: v for k, v in _routes_since(before).items() if v}}
            if name == "swap":
                r["swaps"] = dict(swaps)
                r["swap_d2h_gb_s"] = swaps["out_bytes"] / max(1e-9, swaps["out_s"]) / 1e9
                r["swap_h2d_gb_s"] = swaps["in_bytes"] / max(1e-9, swaps["in_s"]) / 1e9
            log(f"[preempt] {name}: {json.dumps(r, default=int)}")
            pool = ce.kv.pool
            if pool.n_free != pool.n_pages or pool.refs or ce.kv.host_stats()["pages_in_use"]:
                fail(f"preempt {name}: pages leaked at teardown")
            ce.check_invariants()
            if any(len(t) != SERVE_NEW for t in toks):
                fail(f"preempt {name}: a request is short")
            runs[name] = (toks, r)
            _add(total, launches)
    finally:
        KV.PagedKVManager.swap_out, KV.PagedKVManager.swap_in = orig_out, orig_in
    sw, rc = runs["swap"][1], runs["recompute"][1]
    if sw["preemptions"] < 1 or sw["recomputes"] or swaps["round_trips"] < 1 or \
            sw["host"]["swap_out_bytes"] != sw["host"]["swap_in_bytes"]:
        fail(f"preempt: the swap run did not swap out and back: {sw}")
    if rc["preemptions"] < 1 or rc["recomputes"] != rc["resumes"] or \
            rc["host"]["swap_out_bytes"]:
        fail(f"preempt: the recompute run did not recompute: {rc}")
    stall = runs["stall"][0]
    traces = {}
    for name, (toks, _) in list(runs.items()) + [("serve", (serve_toks, None))]:
        equal = [list(t) for t in toks] == [list(t) for t in stall]
        log(f"[preempt] tokens of {name} == stall run's: {equal}")
        if equal:
            continue
        for n in ("stall", name):
            if n not in traces:
                extra = ({} if n in ("stall", "serve") else
                         dict(preemption=True,
                              kv_host_pages=2 * pool_pages if n == "swap" else 0))
                kw_n = (dict(max_slots=SERVE_SLOTS, slot_len=256) if n == "serve"
                        else dict(kw, **extra))
                traces[n] = _traced_serve(eng, cfg, prompts, news, **kw_n)[0]
        _hold_positions(f"preempt] [{name}", traces[name], traces["stall"],
                        (name, "stall"), False)
    log(f"[preempt] {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_chaos(dev, eng, cfg):
    """``[main]``'s model (packed, 8 layers) on pages of 16 under the
    reference's chaos workload (16 requests, prompts of 8/16, 8-24 new
    tokens, 3 slots, ``expert_fetch=0.05,nan_logits@3``, every 6th client
    cancelling after its first token) with the audit on every step,
    against the same traffic fault-free.  Goodput ratio, retries, degraded
    layers, statuses, the host reads of the fault mode's logits per step,
    launches by binding and route (a degraded layer runs the batched
    binding: 3 launches each instead of the slot binding's 3); the pool
    empty with no reference left at teardown; the survivors' tokens held
    to the fault-free run's by request and position under the near-tie
    rule."""
    import torch
    from repro_torch.benchmarks import serve_bench
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    workload, stride = serve_bench.chaos_workload(cfg)
    prompts = [p for p, _ in workload]
    L = eng.n_moe_layers
    runs, total = {}, {}
    for name, inject in (("clean", False), ("chaos", True)):
        calls = {}
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        before = _routes()
        tps, ce, reqs = serve_bench.drive_chaos(
            cfg, eng, workload, inject=inject, cancel_stride=stride, page=16,
            on_engine=lambda e: _counted_exec(e, calls))
        _uncount_exec(ce._exec)
        launches, routes = ops.launches(), _routes_since(before)
        s = ce.stats()
        dec, chunks = calls.get("decode", 0), calls.get("prefill_chunk_row", 0)
        degraded = s["faults_fetch_degraded"]
        expect = {"dequant_matmul": 0,
                  "dequant_matmul_batched": 3 * (L * chunks + degraded),
                  "dequant_matmul_slots": 3 * (L * dec - degraded),
                  "flash_attention": 0,
                  "ragged_attention": cfg.n_layers * (dec + chunks)}
        r = {"delivered_tok_s": tps, "steps": ce.step_count, "decode_calls": dec,
             "admission_chunks": chunks,
             "statuses": [q.status for q in reqs],
             "faults": {k[7:]: v for k, v in s.items() if k.startswith("faults_")},
             "host_logit_bytes_per_decode_step":
                 (ce.max_slots * cfg.padded_vocab * 4) if inject else 0,
             "pool_empty": ce.kv.pool.n_free == ce.kv.pool.n_pages,
             "refs": dict(ce.kv.pool.refs), "launches": launches,
             "launches_expected": expect,
             "routes": {k: v for k, v in routes.items() if v}}
        log(f"[chaos] {name}: {json.dumps(r, default=int)}")
        if launches != expect:
            fail(f"chaos {name}: launches {launches} != expected {expect}")
        runs[name] = (reqs, r)
        _add(total, launches)
    (clean, rc), (chaos, rx) = runs["clean"], runs["chaos"]
    ratio = rx["delivered_tok_s"] / rc["delivered_tok_s"]
    f = rx["faults"]
    survivors = [i for i, q in enumerate(chaos) if q.status == "completed"]
    equal = all(chaos[i].generated == clean[i].generated for i in survivors)
    log(f"[chaos] goodput {rx['delivered_tok_s']:.2f} vs {rc['delivered_tok_s']:.2f} "
        f"tok/s: ratio {ratio:.3f} (floor 0.7); fired expert_fetch "
        f"{f['fired_expert_fetch']}, retries {f['fetch_retries']}, degraded layers "
        f"{f['fetch_degraded']}; completed {f['completed']}, cancelled "
        f"{f['cancelled']}, failed {f['failed']}; survivors' tokens equal the "
        f"clean run's: {equal}; {time.perf_counter() - t_phase:.1f} s")
    if not (rx["pool_empty"] and rc["pool_empty"]) or rx["refs"] or rc["refs"]:
        fail("chaos: the pool is not empty at teardown")
    if f["fired_expert_fetch"] < 1 or f["failed"] != 1 or \
            f["cancelled"] != len(workload) // stride:
        fail(f"chaos: the schedule did not play out: {f}")
    if ratio < 0.7:
        fail(f"chaos goodput {ratio:.3f}x below the 0.7x floor")
    if not equal:
        traces = {}
        for name, inject in (("clean", False), ("chaos", True)):
            held = []
            serve_bench.drive_chaos(
                cfg, eng, workload, inject=inject, cancel_stride=stride, page=16,
                on_engine=lambda e: held.append(
                    _pos_trace_serving(e, prompts).__enter__()))
            held[0].__exit__()
            traces[name] = held[0]
        for i in range(len(workload)):  # survivors only
            if i not in survivors:
                for t in traces.values():
                    t.ev = {k: v for k, v in t.ev.items() if k[0] != i}
        _hold_positions("chaos", traces["chaos"], traces["clean"],
                        ("chaos", "clean"), False)
    return total


ITEM5_CASES = ("prefix_plain", "prefix_packed", "swap_resume",
               "recompute_resume", "priority_packed", "chaos_packed",
               "cancel_swapped", "step_deadline", "nan_plain", "nan_packed",
               "fetch_degraded")


def _item5_case(name, cfg, params, off, where):
    """One case of ``[item5-parity]`` on ``where``: the plain plane over
    ``params`` or the packed one over ``off``; returns what card and CPU
    must agree on exactly."""
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.faults import FaultInjector
    rng = np.random.default_rng(7)
    sys_p = rng.integers(1, cfg.vocab_size, 24)
    shared = [np.concatenate([sys_p, rng.integers(1, cfg.vocab_size, n)])
              for n in (5, 3, 6)]
    tri = [rng.integers(1, cfg.vocab_size, n) for n in (9, 7, 8)]
    four = [rng.integers(1, cfg.vocab_size, n) for n in (12, 14, 10, 12)]
    pre = dict(max_slots=3, slot_len=48, kv_page=4, kv_pages_total=10,
               preemption=True, kv_host_pages=8)
    plane, prompts, news, pri, kw, sub, action = {
        "prefix_plain": ("plain", shared, [6, 5, 4], None,
                         dict(max_slots=1, slot_len=64, kv_page=8,
                              prefix_cache_pages=12), {}, None),
        "prefix_packed": ("packed", shared, [6, 5, 4], None,
                          dict(max_slots=1, slot_len=64, kv_page=8,
                               prefix_cache_pages=8), {}, None),
        "swap_resume": ("plain", tri, [8] * 3, [0, 0, 5], pre, {}, None),
        "recompute_resume": ("plain", tri, [8] * 3, [0, 0, 5],
                             dict(pre, kv_host_pages=0), {}, None),
        "priority_packed": ("packed", tri, [8] * 3, [0, 0, 5],
                            dict(pre, kv_pages_total=6), {}, None),
        "chaos_packed": ("packed", four * 2, [10, 6, 8, 9] * 2, None,
                         dict(max_slots=3, slot_len=64, kv_page=8,
                              faults="expert_fetch=0.05,nan_logits@3"), {},
                         "cancel_every_4th"),
        "cancel_swapped": ("plain", four, [10] * 4, None,
                           dict(pre, kv_pages_total=13, kv_host_pages=12,
                                slot_len=64), {}, "cancel_swapped"),
        "step_deadline": ("plain", tri[:2], [20, 20], None,
                          dict(max_slots=2, slot_len=64), dict(deadline_steps=3),
                          None),
        "nan_plain": ("plain", tri, [6, 8, 6], None,
                      dict(max_slots=3, slot_len=64, faults="nan_logits@1"), {},
                      None),
        "nan_packed": ("packed", tri, [6, 8, 6], None,
                       dict(max_slots=3, slot_len=48, faults="nan_logits@1"), {},
                       None),
        "fetch_degraded": ("packed", tri, [6, 8, 6], None,
                           dict(max_slots=3, slot_len=48, kv_page=16,
                                faults="expert_fetch=1.0"), {}, None),
    }[name]
    if "faults" in kw:
        kw = dict(kw, faults=FaultInjector.parse(kw["faults"], seed=0))
    ce = ContinuousEngine(params if plane == "plain" else None, cfg,
                          offload=off if plane == "packed" else None,
                          eos_id=None, check_invariants=True,
                          device=where if plane == "plain" else None, **kw)
    steps = {}
    reqs = [ce.submit(p, n, priority=q, on_token=lambda r, t: steps.setdefault(
        r.rid, []).append(ce.step_count), **sub)
        for p, n, q in zip(prompts, news, pri or [0] * len(prompts))]
    cancelled = set()
    while ce.sched.has_waiting or ce.sched.n_running or ce._swapped:
        ce.step()
        if action == "cancel_every_4th":
            for i, r in enumerate(reqs):
                if i % 4 == 3 and r.generated and r.state != "finished":
                    ce.cancel(r.rid)
        elif action == "cancel_swapped" and ce._swapped and not cancelled:
            cancelled.add(ce._swapped[0].req.rid)
            ce.cancel(ce._swapped[0].req.rid)
        if ce.step_count > 2000:
            fail(f"item5-parity {name}: the engine hung")
    cached = ce._prefix.n_pages if ce._prefix is not None else 0
    if ce.paged and ce.kv.pool.n_free + cached != ce.kv.pool.n_pages:
        fail(f"item5-parity {name}: pages leaked on {where}")
    s = ce.stats()
    return {"tokens": [r.generated for r in reqs],
            "steps": [steps.get(r.rid, []) for r in reqs],
            "status": [r.status for r in reqs],
            "stats": {k: v for k, v in s.items() if k.startswith(
                ("faults_", "prefix_", "kv_host_", "offload_", "kv_pages"))}}


def phase_item5_parity(dev):
    """``tiny-moe`` (f32, seeded weights, full size) card against CPU, on
    the plain plane and the packed one (the model's offload spec): prefix
    hits on both planes; swap resume, recompute resume and priority
    preemption; the chaos schedule with cancelling clients; a cancel
    while swapped out; a step deadline; NaN quarantine on both planes;
    every fetch failing (each MoE layer of every decode step degraded to
    store-direct, the batched binding) on pages.
    Tokens, emit steps, statuses and the ``faults_*``, ``prefix_*``,
    ``kv_host_*``, ``offload_*`` and page counters exactly equal.  Returns
    the card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import (OffloadEngine,
                                                 quantize_for_offload)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = get_config("tiny-moe")
    spec = cfg.offload
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, spec,
                                                 pack_experts=True, device="cpu")
    runs, launches = {}, {}
    for where in ("cpu", dev):
        ops.reset_launches()
        p = _to(params, where)
        off = OffloadEngine(_to(exec_params, where), cfg, spec, quantized=True,
                            store=store if where == "cpu" else _cpu_store_to(store, where),
                            device=where)
        for name in ITEM5_CASES:
            runs[str(where), name] = _item5_case(name, cfg, p, off, where)
        if where != "cpu":
            launches = ops.launches()
    unequal = [n for n in ITEM5_CASES if runs[str(dev), n] != runs["cpu", n]]
    summary = {n: {"status": runs[str(dev), n]["status"],
                   **{k: v for k, v in runs[str(dev), n]["stats"].items()
                      if k in ("prefix_prefills_skipped", "kv_host_preemptions",
                               "kv_host_recomputes", "kv_host_swap_out_bytes",
                               "faults_fetch_retries", "faults_fetch_degraded",
                               "faults_nan_quarantined")}}
               for n in ITEM5_CASES}
    log(f"[item5-parity] tiny-moe card vs cpu: cases differing {unequal}; "
        f"{json.dumps(summary, default=int)}; card launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    for n in unequal:
        a, b = runs[str(dev), n], runs["cpu", n]
        key = next(k for k in a if a[k] != b[k])
        log(f"[item5-parity] {n}: {key} card {a[key]} vs cpu {b[key]}")
    if unequal:
        fail(f"item5-parity: the card differs from the CPU on {unequal}")
    checks = {"prefix_plain": ("prefix_prefills_skipped", 2),
              "prefix_packed": ("prefix_prefills_skipped", 2)}
    for n, (k, v) in checks.items():
        if runs["cpu", n]["stats"][k] != v:
            fail(f"item5-parity {n}: {k} {runs['cpu', n]['stats'][k]} != {v}")
    for n in ("swap_resume", "recompute_resume", "priority_packed", "cancel_swapped"):
        if runs["cpu", n]["stats"]["kv_host_preemptions"] < 1:
            fail(f"item5-parity {n}: no preemption")
    if runs["cpu", "chaos_packed"]["stats"]["faults_fired_expert_fetch"] < 1 or \
            runs["cpu", "nan_packed"]["stats"]["faults_nan_quarantined"] != 1 or \
            runs["cpu", "fetch_degraded"]["stats"]["offload_demand_loads"] or \
            runs["cpu", "fetch_degraded"]["stats"]["faults_fetch_degraded"] < 1:
        fail("item5-parity: the fault schedules did not fire")
    return launches

# ----------------------------------------------------------------------
# telemetry, the launchers, the attention bench and F4 (item 7)
def _schema_check(label, metrics, trace):
    """The port's schema checker (``repro_torch.obs.check_schema``, on the
    port's schema of record) on a metrics and trace file: no violation."""
    from repro_torch.obs import check_schema
    errors = check_schema.check_metrics(Path(metrics)) + \
        check_schema.check_trace(Path(trace))
    log(f"[{label}] schema checker: {len(errors)} violations in {metrics} "
        f"and {trace}" + "".join(f"\n  {e}" for e in errors))
    if errors:
        fail(f"{label}: {metrics} / {trace} fail the schema checker")


def _roofline(snap):
    return {k: snap["roofline"][k] for k in (
        "hw", "windows", "measured_tok_s", "predicted_tok_s", "delta_ratio",
        "measured_h2d_bytes_per_token", "naive_h2d_bytes_per_token",
        "h2d_savings_ratio")}


def phase_telemetry(dev, eng, cfg, serve_toks, prompt, main_toks):
    """``[serve]``'s model and requests served with telemetry fully on
    (timing, trace, roofline) and off: equal tokens (the ported
    ``telemetry_overhead``: interleaved off and on steps, the ratio of
    their summed step times held to the reference's 0.95; then a traced
    run against ``[serve]``'s tokens),
    host synchronisations per decode step equal on and off, the roofline,
    the metrics and trace files through the schema tool.  Then ``[main]``'s
    ``OffloadEngine`` traced: ``[main]``'s tokens, its files through the
    tool.  Returns the launches of the traced runs."""
    import torch
    from repro_torch.benchmarks import serve_bench
    from repro_torch.core.offload_engine import OffloadEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import ContinuousEngine
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    news = [SERVE_NEW] * SERVE_REQUESTS
    row = serve_bench.run_telemetry_overhead(
        None, cfg, smoke=True, max_slots=SERVE_SLOTS, offload=eng,
        workload=list(zip(prompts, news)), kv_page=16)
    log(f"[telemetry] overhead {json.dumps(row)}")
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256, kv_page=16)
    syncs = {name: _decode_syncs(eng, cfg, prompts[:SERVE_SLOTS], dict(
        kw, telemetry=Telemetry(timing=True, trace=True) if on else None))
        for name, on in (("off", False), ("on", True))}
    log(f"[telemetry] host syncs per decode step {json.dumps(syncs)}")
    window = Telemetry().roofline_window
    if abs(syncs["on"]["per_step"] - syncs["off"]["per_step"]) > 1 / window:
        fail(f"telemetry changed the host syncs per decode step: {syncs}")
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    tel = Telemetry(timing=True, trace=True)
    ce = ContinuousEngine(None, cfg, offload=eng, eos_id=None, telemetry=tel,
                          **kw)
    reqs = [ce.submit(p, m) for p, m in zip(prompts, news)]
    ce.run(max_steps=1000)
    launches = ops.launches()
    if [r.generated for r in reqs] != serve_toks:
        fail("[telemetry] the traced run's tokens differ from [serve]'s")
    snap = ce.metrics()
    log(f"[telemetry] serving: step {json.dumps(snap['step'])}; exec "
        f"{json.dumps(snap['exec'])}; roofline {json.dumps(_roofline(snap))}; "
        f"{len(tel.tracer.events)} trace events")
    m, t = out_dir / "serve_metrics.json", out_dir / "serve_trace.json"
    tel.write_metrics(m, {"engine": "continuous", "arch": cfg.name,
                          "kv_layout": "paged", "offloaded": True,
                          "timing": True, "plane": ce._exec.plane,
                          "roofline": True, "faults": True})
    tel.write_trace(t)
    _schema_check("telemetry", m, t)
    # the batch-1 engine: [main]'s store and weights, traced
    tel = Telemetry(timing=True, trace=True)
    off = OffloadEngine(eng.params, cfg, eng.spec, quantized=True,
                        store=eng.store, device=dev, telemetry=tel)
    off.generate(prompt[:, :8], 3)  # warm-up
    ops.reset_launches()
    toks, _ = off.generate(prompt, NEW_TOKENS)
    _add(launches, ops.launches())
    if not (toks == main_toks).all():
        fail("[telemetry] the traced OffloadEngine's tokens differ from [main]'s")
    snap = off.metrics()
    traced_tok_s = (NEW_TOKENS - 1) / off.last_timing["decode_s"]
    log(f"[telemetry] offload engine: decode {traced_tok_s:.2f} tok/s traced; "
        f"exec {json.dumps(snap['exec'])}; request "
        f"{json.dumps(snap['request'])}; roofline "
        f"{json.dumps(_roofline(snap))}")
    m, t = out_dir / "offload_metrics.json", out_dir / "offload_trace.json"
    tel.write_metrics(m, {"engine": "offload", "arch": cfg.name,
                          "offloaded": True, "timing": True,
                          "plane": off._exec.plane, "roofline": True})
    tel.write_trace(t)
    _schema_check("telemetry", m, t)
    del off
    shutil.rmtree(out_dir)
    log(f"[telemetry] launches {launches}; {time.perf_counter() - t_phase:.1f} s")
    return launches


def _module(label, args, timeout):
    """``python -m`` of a port entry point from the checkout's root, in
    its own process; must exit 0.  Returns its standard output."""
    root = Path(__file__).resolve().parent
    env = dict(__import__("os").environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m"] + args, cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = "\n".join(ln for ln in r.stdout.strip().splitlines()
                      if not ln.startswith(("[step ", "step ")))
    log(f"[{label}] python -m {' '.join(args)}: exit {r.returncode} in {wall:.1f} s\n"
        f"{lines}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        fail(f"[{label}] python -m {args[0]} exited {r.returncode}")
    return r.stdout


def _refused(args, refused):
    """``launch.serve``'s ``main(args)`` in this process (a refusal exits
    before it loads a model, so a process of its own would only add its
    start-up): it must exit with a message that matches ``refused`` (a
    regular expression)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            serve.main(args)
        said = None
    except SystemExit as e:
        said = str(e.code)
    log(f"[cli] launch.serve {' '.join(args)}: refusal in "
        f"{time.perf_counter() - t0:.1f} s: {said!r}")
    if said is None or not re.search(refused, said):
        fail(f"[cli] launch.serve {' '.join(args)} was not refused as "
             f"{refused!r}")


# (arch, shape, layers timed on the card; None = all): the counts are
# always the full depth's
# (xlstm-1.3b train_4k at one period of 6 layers: 113 s on an H100, of it
# a 71.7 s step through its 4096-position sLSTM loop; left out, PERF.md)
DRYRUN_COMBOS = (("mixtral-8x7b", "decode_32k", None),
                 ("granite-moe-1b-a400m", "train_4k", 4),
                 ("smollm-360m", "prefill_32k", 4))


def phase_dryrun(card):
    """Rank 0's share of the 16x16 production mesh on the card, at the
    published widths (mixtral at full depth; granite and smollm timed at
    4 layers, counted at full depth), under a fake world of 256 ranks
    (``launch.dryrun``; collectives move nothing), in its own process:
    mixtral-8x7b decode_32k (serve TP-only, KV window split on "model"),
    granite train_4k (expert parallel, 2 microbatches, remat) and smollm
    prefill_32k (32768 positions, heads not split).  Each combo: the
    argument bytes held on the card must equal the spec trees' exactly,
    the peak must fit in 80 GiB, the step time, the roofline terms on the
    ``h100`` row and the collectives by type are printed.  No kernel of
    the port is on this path (the reference's dry-run reaches none)."""
    root = Path(__file__).resolve().parent
    out = root / "chiprun_out" / "dryrun_torch"
    code = (
        "import torch\n"
        "from pathlib import Path\n"
        "from repro_torch.launch import dryrun as D, mesh as M\n"
        "M.start_fake_world(256)\n"
        "m = M.make_production_mesh()\n"
        "x = torch.zeros(1, device=m.device_type)\n"
        "assert m.device_type == 'cuda' and x.device.index == 0, x.device\n"
        "print('[dryrun] fake world of', torch.distributed.get_world_size(),"
        " 'ranks; rank 0 on', x.device, flush=True)\n"
        "import time\n"
        f"for a, s, n in {list(DRYRUN_COMBOS)!r}:\n"
        "    t0 = time.perf_counter()\n"
        f"    D.run_one(a, s, False, Path({str(out)!r}), card_layers=n)\n"
        "    print(f'[dryrun] {a} x {s}: {time.perf_counter() - t0:.1f} s',"
        " flush=True)\n")
    env = dict(__import__("os").environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log("\n".join(ln for ln in r.stdout.splitlines()
                  if ln.startswith("[dryrun]")))
    if r.returncode != 0:
        log(r.stderr[-4000:])
        fail(f"[dryrun] exited {r.returncode}")
    for arch, shape, _ in DRYRUN_COMBOS:
        res = json.loads((out / f"{arch}__{shape}__pod16x16.json").read_text())
        ma, rf = res["memory_analysis"], res["roofline"]
        if res["status"] != "ok" or res["n_devices"] != 256:
            fail(f"[dryrun] {arch} x {shape}: {res['status']}")
        if ma["argument_bytes_held"] != ma["step_argument_bytes"]:
            fail(f"[dryrun] {arch} x {shape}: {ma['argument_bytes_held']} "
                 f"argument bytes on the card, {ma['step_argument_bytes']} "
                 f"from the spec trees")
        peak = ma["peak_estimate_bytes"]
        if not 0 < peak <= 80 * 2 ** 30:
            fail(f"[dryrun] {arch} x {shape}: peak {peak} bytes")
        if not (res["step_ms"] > 0 and rf["flops_per_chip"] > 0):
            fail(f"[dryrun] {arch} x {shape}: step {res['step_ms']} ms, "
                 f"{rf['flops_per_chip']} flops")
        log(f"[dryrun] {arch} x {shape} x pod16x16 rank 0 on {card}: "
            f"argument bytes {ma['argument_bytes_held']} on the card == "
            f"spec trees at {res['step_layers']} layers "
            f"({ma['argument_bytes_held'] / 2 ** 30:.3f} GiB; "
            f"{ma['argument_bytes'] / 2 ** 30:.3f} GiB at full depth); peak "
            f"{peak / 2 ** 30:.2f} GiB; step {res['step_ms']:.1f} ms at "
            f"{res['step_layers']} of {res['n_layers']} layers; "
            f"roofline (h100 row) compute {rf['t_compute_s'] * 1e3:.2f} ms "
            f"memory {rf['t_memory_s'] * 1e3:.2f} ms collective "
            f"{rf['t_collective_s'] * 1e3:.2f} ms -> {rf['bottleneck']}; "
            f"flops/chip {rf['flops_per_chip']:.4g}, HBM bytes/chip "
            f"{rf['hbm_bytes_per_chip']:.4g}; collectives "
            f"{ {k: round(v / 2 ** 30, 3) for k, v in rf['collective_by_type'].items()} }"
            f" GiB in {res['collective_ops']} ops; useful flops "
            f"{res['useful_flops_ratio']:.3f}; tp_only "
            f"{res['serve_tp_only']}; counted and built in "
            f"{res['lower_s']:.1f} s")
    log(f"[dryrun] {len(DRYRUN_COMBOS)} combos in {wall:.1f} s")


CLI_REQUESTS = 5  # the zoo's continuous launcher runs (12 by default; the
                  # script's time limit): one more than the launcher's 4
                  # slots, so each run admits a request into a freed slot


def phase_cli(dev):
    """The port's launchers as a user runs them, each in its own process
    (the two refusals in this one, ``_refused``):
    ``launch.serve`` on ``mixtral-offload`` at its published 32 layers
    (``--offload --quantize``, 8 new tokens per prompt, metrics and
    trace), then ``launch.train`` of ``tiny-moe`` for 20 steps into a
    checkpoint that ``launch.serve`` serves continuously on pages with the
    prefix cache, preemption, injected expert-fetch faults and the packed
    plane.  Every run exits 0 and its files pass the schema tool."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path(tempfile.mkdtemp())
    m, t = out_dir / "offload_metrics.json", out_dir / "offload_trace.json"
    out = _module("cli", ["repro_torch.launch.serve", "--config",
                          "mixtral-offload", "--offload", "--quantize",
                          "--max-new", "8", "--metrics-json", str(m),
                          "--trace", str(t)], timeout=600)
    if "published width" not in out or len(re.findall(r"^gen: ", out, re.M)) != 2:
        fail("[cli] the 32-layer offload run did not serve its two prompts "
             "at the published width")
    _schema_check("cli", m, t)
    # the config zoo by --arch, as published: granite on the packed plane,
    # smollm served continuously, command-r-plus refused for its size
    out = _module("cli", ["repro_torch.launch.serve", "--arch",
                          "granite-moe-1b-a400m", "--offload", "--quantize",
                          "--max-new", "8"], timeout=300)
    if len(re.findall(r"^gen: ", out, re.M)) != 2:
        fail("[cli] granite did not serve its two prompts")
    out = _module("cli", ["repro_torch.launch.serve", "--arch", "smollm-360m",
                          "--continuous", "--max-new", "8", "--n-requests",
                          str(CLI_REQUESTS)], timeout=300)
    if f"[continuous] {CLI_REQUESTS} requests" not in out:
        fail(f"[cli] smollm's continuous run did not finish its "
             f"{CLI_REQUESTS} requests")
    _refused(["--arch", "command-r-plus-104b", "--continuous"],
             r"needs [0-9.]+ GB of device memory .* GB free")
    # the recurrent zoo and the encoder-decoder at their published widths;
    # whisper outside --continuous refused
    for arch in REC_ARCHS + (WHISPER,):
        out = _module("cli", ["repro_torch.launch.serve", "--config", arch,
                              "--continuous", "--max-new", "8", "--n-requests",
                              str(CLI_REQUESTS)], timeout=300)
        wide = arch == WHISPER or "published width" in out  # 1024 wide: never reduced
        if (f"[continuous] {CLI_REQUESTS} requests" not in out or not wide
                or "reduced" in out):
            fail(f"[cli] {arch}'s continuous run did not finish its "
                 f"{CLI_REQUESTS} requests at the published width")
    _refused(["--config", WHISPER], r"encoder-decoder: serve it with --continuous")
    ck = out_dir / "tiny_moe.npz"
    _module("cli", ["repro_torch.launch.train", "--arch", "tiny-moe",
                    "--steps", "20", "--checkpoint", str(ck)], timeout=300)
    m, t = out_dir / "serve_metrics.json", out_dir / "serve_trace.json"
    out = _module("cli", ["repro_torch.launch.serve", "--config", "tiny-moe",
                          "--checkpoint", str(ck), "--continuous", "--kv-page",
                          "16", "--prefix-cache", "8", "--preemption", "on",
                          "--inject-faults", "expert_fetch=0.05", "--offload",
                          "--quantize", "--metrics-json", str(m), "--trace",
                          str(t)], timeout=300)
    if "[continuous] 12 requests" not in out:
        fail("[cli] the continuous run did not finish its 12 requests")
    _schema_check("cli", m, t)
    shutil.rmtree(out_dir)


def phase_attention_bench(dev):
    """The ported ``attention_bench`` at its full size on the card: the
    dense ring against ``ops.ragged_attention`` (``ragged_mma``, bf16) as
    the live context sweeps 1/8 to full, each ragged result held to its
    plain version; the work-list lengths.  Returns the ragged launches of
    its timed runs."""
    from repro_torch.benchmarks import attention_bench
    t0 = time.perf_counter()
    before = _routes()
    rows = attention_bench.run(device=dev)
    routes = _routes_since(before)
    for r in rows:
        log(f"[attention-bench] {json.dumps(r)}")
    n = sum(r.get("ragged_launches", 0) for r in rows)
    if n < 1 or routes["ragged_warp"]:
        fail(f"[attention-bench] the ragged kernel did not run on mma: {routes}")
    log(f"[attention-bench] {n} ragged launches (routes {routes}); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ragged_attention": n}


def phase_f4(dev):
    """F4's minimal case (ROADMAP §3) on the card: ``tiny-moe`` at 2
    layers in f32 (the FMA routes), two prompts of 19 and 21 tokens, pages
    of 4 in an 11-page pool, chunks of 4, preemption, on the plain plane
    and over the packed pool; the reference raises here.  Tokens, emit
    steps and the preemption counters equal to the CPU's, every page back
    in the pool.  Returns the card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadEngine, quantize_for_offload
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = get_config("tiny-moe").replace(n_layers=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (19, 21)]
    params = T.init_model(cfg, seed=0, device="cpu")
    exec_params, _, store = quantize_for_offload(params, cfg, cfg.offload,
                                                 pack_experts=True, device="cpu")
    kw = dict(max_slots=2, slot_len=48, kv_page=4, kv_pages_total=11,
              preemption=True, prefill_chunk=4, check_invariants=True)
    runs, launches = {}, {}
    for where in ("cpu", dev):
        ops.reset_launches()
        off = OffloadEngine(_to(exec_params, where), cfg, cfg.offload,
                            quantized=True, device=where,
                            store=store if where == "cpu" else _cpu_store_to(store, where))
        for plane in ("plain", "packed"):
            ce, toks, steps, _ = _serve(
                off if plane == "packed" else None, cfg, prompts, [8, 8],
                params=_to(params, where), device=where, **kw)
            if ce.kv.pool.n_free != ce.kv.pool.n_pages:
                fail(f"[f4] {plane} on {where}: pages leaked")
            s = ce.stats()
            runs[str(where), plane] = (toks, steps, s["kv_host_preemptions"],
                                       s["kv_host_recomputes"])
        if where != "cpu":
            launches = ops.launches()
    for plane in ("plain", "packed"):
        card, cpu = runs[str(dev), plane], runs["cpu", plane]
        log(f"[f4] {plane}: card {card} cpu {cpu}")
        if card != cpu or card[2] < 1:
            fail(f"[f4] {plane}: the card differs from the CPU or nothing was preempted")
    log(f"[f4] card launches {launches}")
    return launches


# ----------------------------------------------------------------------
# the attention-only config zoo
ZOO_ARCHS = ("granite-moe-1b-a400m", "smollm-360m", "stablelm-1.6b",
             "qwen1.5-4b", "command-r-plus-104b", "phi-3-vision-4.2b")
ZOO_LAYERS = {"command-r-plus-104b": 8}  # of 64: ~31 GB of bf16 weights
# granite at its published expert count, top-k and offload spec, widths cut
# by hand (reduced() would give 4 experts and top-2, below its cache of 8)
GRANITE_NARROW = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                      head_dim=64, d_ff=64, vocab_size=512, dtype="float32")
# tail layers (3 of a 2-layer pattern, a dense geglu tail after an MoE
# period) on tiny-moe; a logit softcap with a padded vocabulary on smollm
ZOO_TAIL = dict(n_layers=3, block_pattern=("attn+mlp", "swa+moe"),
                mlp_act="geglu", d_model=128, d_ff=128)
ZOO_SOFTCAP = dict(logit_softcap=5.0, vocab_size=500)
# phi-3 at its head_dim 96 (2 heads x 96), and the published GQA ratios 3
# (smollm) and 12 (command-r-plus), which reduced() makes 64 and 4
ZOO_NARROW = {
    "phi3-hd96": ("phi-3-vision-4.2b", False,
                  dict(n_layers=2, d_model=192, n_heads=2, n_kv_heads=2,
                       head_dim=96, d_ff=256, vocab_size=512,
                       num_image_tokens=4, dtype="float32")),
    "gqa3": ("smollm-360m", True, dict(n_heads=6, n_kv_heads=2, head_dim=32)),
    "gqa12": ("command-r-plus-104b", True,
              dict(n_heads=12, n_kv_heads=1, head_dim=32)),
}


class _PlainKernels:
    """Within it every kernel binding of ``kernels.ops`` runs its plain
    PyTorch version whatever the device: the same model on the card with
    no kernel, to hold a kernel run to."""

    NAMES = ("dequant_matmul", "dequant_matmul_batched", "dequant_matmul_slots",
             "flash_attention", "ragged_attention")

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA, ops, ref
        from repro_torch.kernels import ragged_attention as RA
        self.ops, self.saved = ops, {n: getattr(ops, n) for n in self.NAMES}
        ops.dequant_matmul = ref.dequant_matmul
        ops.dequant_matmul_batched = lambda x, qt, offsets=None: (
            ref.dequant_matmul_batched(x, qt) if offsets is None
            else ref.dequant_matmul_grouped(x, qt, offsets))
        ops.dequant_matmul_slots = ref.dequant_matmul_slots
        ops.flash_attention = FA.flash_attention_reference
        ops.ragged_attention = lambda q, kp, vp, ppos, pages, qpos, *, window=None, \
            worklist=None: RA.ragged_attention_reference(q, kp, vp, ppos, pages, qpos,
                                                         window=window)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)


def _zoo_config(name):
    """A ``[zoo-parity]`` config: a zoo name reduced, or ``granite-32x8``,
    ``tail``, ``softcap``."""
    from repro_torch.configs import get_config
    if name == "granite-32x8":
        return get_config("granite-moe-1b-a400m").replace(**GRANITE_NARROW)
    if name == "tail":
        return get_config("tiny-moe").replace(**ZOO_TAIL)
    if name == "softcap":
        return get_config("smollm-360m").reduced().replace(**ZOO_SOFTCAP)
    if name in ZOO_NARROW:
        base, reduce, kw = ZOO_NARROW[name]
        cfg = get_config(base)
        return (cfg.reduced() if reduce else cfg).replace(**kw)
    return get_config(name).reduced()


def _random_norms(params, seed):
    """Random norm scales and biases, attention biases, the recurrent
    mixers' head norms and conv biases (the init makes them 1 and 0, which
    would hide a missing term)."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        z = torch.randn(t.shape, generator=gen).to(t.dtype)
        if key in ("scale", "headnorm"):
            return 1 + 0.2 * z
        if key in ("bias", "bq", "bk", "bv", "bo", "conv_b"):
            return 0.2 * z
        return t
    return walk(params)


def phase_zoo_parity(dev):
    """The six attention-only zoo configs at ``reduced()`` size in f32,
    card (kernels) against CPU (plain versions), weights from seed 0 with
    random norm scales and biases: ``generate_plain``, ``ContinuousEngine``
    on the plain plane on ``paged`` and ``dense_chunked`` (4 requests
    through 2 slots); granite kept at 32 experts / top-8 / cache 8 through
    ``OffloadEngine`` on ``packed_pipelined``; a tail-layer config (also
    packed), a softcap config, and phi-3 at head_dim 96 and the GQA
    ratios 3 and 12 (reduced() makes them 64 and 4).  Tokens, emit steps
    and counters exactly equal.  Returns the card's launches."""
    from repro_torch.core.offload_engine import (OffloadEngine, generate_plain,
                                                 quantize_for_offload)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    total = {}
    for name in ZOO_ARCHS + ("granite-32x8", "tail", "softcap") + tuple(ZOO_NARROW):
        cfg = _zoo_config(name)
        params = _random_norms(T.init_model(cfg, seed=0, device="cpu"), 1)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 14)]
        news = (8, 5, 7, 4)
        runs = {}
        for where in ("cpu", dev):
            ops.reset_launches()
            p = _to(params, where)
            r = {}
            if name != "granite-32x8":
                r["generate_plain"] = generate_plain(
                    p, cfg, prompts[1][None], 8, device=where).tolist()
            if name not in ("granite-32x8", "tail"):
                for variant, kw in (("paged", {}),
                                    ("dense_chunked", dict(kv_page=None,
                                                           prefill_chunk=4))):
                    _, toks, steps, _ = _serve(None, cfg, prompts, news,
                                               max_slots=2, slot_len=64,
                                               params=p, device=where, **kw)
                    r[variant] = (toks, steps)
            if name in ("granite-32x8", "tail"):
                exec_params, _, store = quantize_for_offload(
                    params, cfg, cfg.offload, pack_experts=True, device="cpu")
                eng = OffloadEngine(_to(exec_params, where), cfg, cfg.offload,
                                    quantized=True, device=where,
                                    store=store if where == "cpu"
                                    else _cpu_store_to(store, where))
                toks, stats = eng.generate(prompts[1][None], 12)
                r["packed_pipelined"] = (toks.tolist(), dataclasses.asdict(stats))
            runs[str(where)] = r
            if where != "cpu":
                _add(total, ops.launches())
        card, cpu = runs[str(dev)], runs["cpu"]
        log(f"[zoo-parity] {name} ({cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}): card == cpu "
            f"{card == cpu} on {sorted(card)}")
        if card != cpu:
            fail(f"[zoo-parity] {name}: the card differs from the CPU: "
                 f"{card} vs {cpu}")
    log(f"[zoo-parity] card launches {total}; {time.perf_counter() - t0:.1f} s")
    return total


def _zoo_requests(cfg):
    """``[serve]``'s 8 requests (prompts of 24-96 tokens, seed 0) at
    ``cfg``'s vocabulary."""
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 97, SERVE_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens], \
        [SERVE_NEW] * SERVE_REQUESTS


def _frontends(cfg, n, seed=1):
    """An encoder-decoder's per-request stub frontends (seeded (S_e,
    d_model) float32 frames, as the launcher's); None per request on any
    other config."""
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(seed)
    return [{"audio_embeds": rng.standard_normal(
        (cfg.encoder_seq, cfg.d_model)).astype(np.float32)} for _ in range(n)]


def _zoo_serve(label, eng, cfg, params, dev, tag="zoo", **serve_kw):
    """``[serve]``'s 8 requests through 4 slots on the packed engine
    ``eng`` or the plain plane over ``params``, on pages of 16 unless
    ``serve_kw`` asks for dense slots with chunked admission
    (``kv_page=None, prefill_chunk=c``): a warm-up, the timed run
    (tokens/s, admission s against decode s, ms per layer per decode
    step, launches against the expected on the tensor-core / FMA routes,
    peak memory, on a stack with recurrent layers the recurrent state
    bytes per row against ``cost_model.recurrent_state_bytes``, and on an
    encoder-decoder the encoder passes' seconds and the encoder-KV bytes
    per row against ``admission_cost().enc_kv_bytes``), then a
    kernel run and a plain-version run of the first 4 requests traced and
    held to the near-tie rule.  Returns (report, launches)."""
    import torch
    from repro_torch.core import cost_model as CM
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import admission_cost
    prompts, news = _zoo_requests(cfg)
    audio = _frontends(cfg, len(prompts))
    kw = dict(max_slots=SERVE_SLOTS, slot_len=256, params=params, device=dev,
              **serve_kw)
    _serve(eng, cfg, prompts[:2], [3, 3], extras=audio and audio[:2], **kw)  # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    before = _routes()
    t = time.perf_counter()
    ce, toks, steps, calls = _serve(eng, cfg, prompts, news, extras=audio, **kw)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches, routes = ops.launches(), _routes_since(before)
    n_tok = sum(len(x) for x in toks)
    paged = kw.get("kv_page", 16) is not None
    n_kv = sum(sp.plane == "kv" for sp in cfg.state_planes())
    if paged:  # every decode step and admission chunk of every KV layer
        want = {"ragged_attention": n_kv * (calls["decode"] + calls["chunks"]),
                "flash_attention": 0}
    else:  # every admission chunk of more than one token, on wgmma
        c = kw["prefill_chunk"]
        want = {"ragged_attention": 0, "flash_attention": n_kv * sum(
            len(x) // c + (len(x) % c > 1) for x in prompts)}
    # an encoder-decoder's cross-attention in every step and chunk of every
    # decoder layer, and the encoder's self-attention once per request
    n_x = sum(sp.mixer == "xattn" for sp in cfg.state_planes())
    want["flash_attention"] += (n_x * (calls["decode"] + calls["chunks"])
                                + cfg.encoder_layers * calls["encodes"])
    report = {"layout": "paged" if paged else "dense_chunked",
              "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
              "steps": ce.step_count, "decode_steps": calls["decode"],
              "admission_chunks": calls["chunks"],
              "admission_s": calls["chunk_s"], "decode_s": calls["decode_s"],
              "encoder_passes": calls["encodes"], "encoder_s": calls["encode_s"],
              "ms_per_layer_per_decode_step": calls["decode_s"] * 1e3
              / max(1, calls["decode"]) / cfg.n_layers,
              "launches": launches, "launches_expected": want,
              "routes": {k: v for k, v in routes.items() if v},
              "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    bad = (any(launches[k] != v for k, v in want.items())
           or routes["ragged_mma"] != want["ragged_attention"]
           or routes["flash_wgmma"] != want["flash_attention"])
    if paged:
        report["pages_peak_committed"] = ce.kv.pool.peak_committed
        bad |= not cfg.has_kv_layers and ce.kv.pool.peak_committed != 0
    if cfg.has_recurrent_layers:
        rec = [blk["rec"] for blk in ce.kv.state["layers"] if "rec" in blk]
        report["rec_state_bytes_per_row"] = sum(
            t[0].numel() * t.element_size() for r in rec for t in r.values())
        report["recurrent_state_bytes"] = CM.recurrent_state_bytes(cfg)
        bad |= report["rec_state_bytes_per_row"] != report["recurrent_state_bytes"]
    if cfg.is_encoder_decoder:
        plane = ce.kv.state["enc_kv"]
        report["enc_kv_bytes_per_row"] = sum(
            t[:, 0].numel() * t.element_size() for t in plane.values())
        report["enc_kv_bytes"] = admission_cost(cfg, 1, 1).enc_kv_bytes
        bad |= (report["enc_kv_bytes_per_row"] != report["enc_kv_bytes"]
                or calls["encodes"] != len(prompts))
    if eng is not None:
        st = ce._pstate
        report.update(hits=int(st.counts[0]), demand_loads=int(st.counts[2]),
                      bytes_h2d_issued=st.h2d_bytes,
                      bytes_h2d_counters=(int(st.counts[2]) + int(st.counts[3]))
                      * eng.expert_bytes)
        bad |= st.h2d_bytes != report["bytes_h2d_counters"]
    log(f"[{tag}] {label} serving {SERVE_REQUESTS} requests / {SERVE_SLOTS} slots: "
        f"{json.dumps(report)}")
    if bad or any(len(x) != SERVE_NEW or not all(0 <= y < cfg.vocab_size for y in x)
                  for x in toks):
        fail(f"[{tag}] {label}: launches / routes / h2d / state bytes / pages "
             f"not as expected, or malformed tokens: {report}")
    # the near-tie hold on the first 4 requests, 12 new tokens each
    held = (prompts[:SERVE_SLOTS], [12] * SERVE_SLOTS)
    kw["extras"] = audio and audio[:SERVE_SLOTS]
    kern = _trace(lambda d: _serve(eng, cfg, *held, on_engine=d.watch, **kw))
    with _PlainKernels():
        plain = _trace(lambda d: _serve(eng, cfg, *held, on_engine=d.watch, **kw))
    diff = _hold_to_near_tie(f"{tag}] [{label} kernels vs plain", kern[0], plain[0],
                             ("kernels", "plain"))
    if diff is None and kern[1][1] != plain[1][1]:
        fail(f"[{tag}] {label}: every decision equal but the tokens differ")
    return report, launches


def phase_zoo(dev):
    """The six attention-only zoo configs at their published widths in
    bf16, random weights from seed 0: granite (24 layers) batch 1 through
    ``OffloadEngine`` on ``packed_pipelined`` (64-token prompt, 32 new
    tokens) and served on its packed pool; smollm, stablelm, qwen and
    phi-3 at full depth and command-r-plus at 8 of 64 layers served on
    the plain plane; ``[serve]``'s 8 requests through 4 slots on pages of
    16.  Each run held to the plain versions on the card by the near-tie
    rule (over the first 16 tokens at batch 1, the first 4 requests' 12
    tokens served).  Returns the launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import OffloadEngine, init_packed_model
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    total = {}
    cfg = get_config("granite-moe-1b-a400m")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, size, store = init_packed_model(cfg, cfg.offload, seed=0, device=dev)
    eng = OffloadEngine(params, cfg, cfg.offload, quantized=True, store=store,
                        device=dev)
    torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))
    eng.generate(prompt[:, :8], 3)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    before = _routes()
    toks, stats = eng.generate(prompt, NEW_TOKENS)
    launches, routes = ops.launches(), _routes_since(before)
    _add(total, launches)
    timing, ps = eng.last_timing, eng._last_pool_state
    steps = timing["decode_steps"]
    L = eng.n_moe_layers
    expect = {"dequant_matmul": 0, "dequant_matmul_batched": 3 * L,
              "dequant_matmul_slots": 3 * L * steps,
              "flash_attention": cfg.n_layers, "ragged_attention": 0}
    accesses = stats.hits + stats.spec_hits + stats.demand_loads
    report = {"layers": cfg.n_layers, "setup_s": setup,
              "store_gib": store.nbytes() / 2**30, "size_report": size,
              "prefill_s": timing["prefill_s"],
              "decode_tok_s": steps / timing["decode_s"],
              "hit_ratio": (stats.hits + stats.spec_hits) / max(1, accesses),
              "stats": {k: getattr(stats, k) for k in
                        ("n_tokens", "hits", "spec_hits", "demand_loads",
                         "spec_loads")},
              "h2d_bytes_per_token": stats.bytes_h2d / max(1, steps),
              "bytes_h2d_issued": ps.h2d_bytes, "bytes_h2d_counters": stats.bytes_h2d,
              "launches": launches, "launches_expected": expect,
              "routes": {k: v for k, v in routes.items() if v},
              "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
              "tokens": toks[0].tolist()}
    log(f"[zoo] granite-moe-1b-a400m batch 1, packed_pipelined: {json.dumps(report)}")
    if (launches != expect or routes["dequant_gemv"] != expect["dequant_matmul_slots"]
            or routes["grouped_grouped"] != expect["dequant_matmul_batched"]
            or ps.h2d_bytes != stats.bytes_h2d or not EP.pool_coherent(store, ps)):
        fail(f"[zoo] granite batch 1: launches / routes / h2d / pool: {report}")
    held = NEW_TOKENS // 2  # the near-tie hold's length
    kern = _trace(lambda d: d.watch(eng).generate(prompt, held))
    with _PlainKernels():
        plain = _trace(lambda d: d.watch(eng).generate(prompt, held))
    diff = _hold_to_near_tie("zoo] [granite batch 1 kernels vs plain", kern[0],
                             plain[0], ("kernels", "plain"))
    if diff is None and not (kern[1][0] == plain[1][0]).all():
        fail("[zoo] granite batch 1: every decision equal but the tokens differ")
    _, launches = _zoo_serve("granite-moe-1b-a400m packed", eng, cfg, None, dev)
    _add(total, launches)
    del eng, params, store
    for arch in ZOO_ARCHS[1:]:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if arch in ZOO_LAYERS:
            cfg = cfg.replace(n_layers=ZOO_LAYERS[arch])
        t0 = time.perf_counter()
        params = T.init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize(dev)
        n = T.count_params_analytic(cfg)
        log(f"[zoo] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, {n / 1e9:.2f}B "
            f"parameters ({n * 2 / 2**30:.1f} GiB bf16) drawn in "
            f"{time.perf_counter() - t0:.1f} s")
        _, launches = _zoo_serve(f"{arch} plain", None, cfg, params, dev)
        _add(total, launches)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------
# the recurrent config zoo (ROADMAP item 6, sub-items 3 and 5)
REC_ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")
REC_CHUNK = 32  # [zoo-rec]'s dense-slot admission chunk
# [zoo-rec]'s depth (the script's time limit): recurrentgemma's four
# (rglru, rglru, swa) periods and its two tail layers, xlstm's two periods
ZOO_REC_LAYERS = {"recurrentgemma-9b": 14, "xlstm-1.3b": 12}


def phase_rec_parity(dev):
    """The recurrent configs at ``reduced()`` size in f32, card (kernels)
    against CPU (plain versions), weights from seed 0 with random norm
    scales, head norms and conv biases, exactly equal: ``generate_plain``
    tokens; the plain plane's ``ContinuousEngine`` (4 requests through 2
    slots: tokens and emit steps) on pages (xlstm on a one-page pool, no
    page reserved) and on dense slots with chunks of 4; draft-and-verify
    on dense slots with an f32 ``tiny-draft`` (k = 2).  Returns the
    card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import generate_plain
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    total = {}
    dcfg = get_config("tiny-draft").replace(dtype="float32")
    dparams = T.init_model(dcfg, seed=1, device="cpu")
    for arch in REC_ARCHS:
        cfg = get_config(arch).reduced()
        params = _random_norms(T.init_model(cfg, seed=0, device="cpu"), 1)
        rng = np.random.default_rng(1)
        # prompt + new within the reduced window of 16 (draft-and-verify)
        prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 9)]
        news = (8, 5, 7, 4)
        runs = {}
        for where in ("cpu", dev):
            ops.reset_launches()
            p = _to(params, where)
            r = {"generate_plain": generate_plain(
                p, cfg, prompts[1][None], 8, device=where).tolist()}
            paged = {} if cfg.has_kv_layers else dict(kv_pages_total=1)
            for variant, kw in (("paged", paged),
                                ("dense_chunked", dict(kv_page=None,
                                                       prefill_chunk=4)),
                                ("dense_spec", dict(
                                    kv_page=None, draft_params=_to(dparams, where),
                                    draft_cfg=dcfg, num_draft_tokens=2))):
                ce, toks, steps, _ = _serve(None, cfg, prompts, news,
                                            max_slots=2, slot_len=64,
                                            params=p, device=where, **kw)
                r[variant] = (toks, steps)
                if variant == "paged" and not cfg.has_kv_layers \
                        and ce.kv.pool.peak_committed != 0:
                    fail(f"[rec-parity] {arch}: pages reserved on a stack "
                         f"without KV layers")
            runs[str(where)] = r
            if where != "cpu":
                _add(total, ops.launches())
        card, cpu = runs[str(dev)], runs["cpu"]
        log(f"[rec-parity] {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.block_pattern}): card == cpu {card == cpu} on {sorted(card)}")
        if card != cpu:
            fail(f"[rec-parity] {arch}: the card differs from the CPU: "
                 f"{card} vs {cpu}")
    log(f"[rec-parity] card launches {total}; {time.perf_counter() - t0:.1f} s")
    return total


def phase_zoo_rec(dev):
    """The recurrent configs at their published widths in bf16, random
    weights from seed 0, depth cut to ``ZOO_REC_LAYERS`` (the script's
    time limit; ``[cli]`` serves both at full depth): recurrentgemma-9b
    (14 of 38 layers, 4 of them SWA at head_dim 256) served on pages of 16
    (ragged at hd 256) and on dense slots with chunked admission (flash at
    hd 256); xlstm-1.3b (12 of 48 layers) at batch 1
    (``Executor.generate_greedy``, 64-token prompt, 32 new tokens: prefill
    s, decode tok/s, equal to the run with the plain versions) and served
    on pages with no page in use.  Returns the
    launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.executor import Executor
    total = {}
    for arch in REC_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch).replace(n_layers=ZOO_REC_LAYERS[arch])
        t0 = time.perf_counter()
        params = T.init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize(dev)
        n = T.count_params_analytic(cfg)
        n_kv = sum(sp.plane == "kv" for sp in cfg.state_planes())
        log(f"[zoo-rec] {arch}: {cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers ({n_kv} with KV), "
            f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
            f"{cfg.head_dim}, {n / 1e9:.2f}B parameters ({n * 2 / 2**30:.1f} "
            f"GiB bf16) drawn in {time.perf_counter() - t0:.1f} s")
        if arch == "xlstm-1.3b":
            ex = Executor(params, cfg, device=dev)
            prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                       (1, PROMPT_LEN))
            ex.generate_greedy(prompt[:, :8], 3)  # warm-up
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            logits, state = ex.prefill(torch.as_tensor(prompt, device=dev),
                                       PROMPT_LEN + NEW_TOKENS)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t
            t = time.perf_counter()
            for _ in range(NEW_TOKENS - 1):
                nxt, state = ex.decode_sampled(state, tok, collect_info=False,
                                               greedy=True)
                tok = nxt[:, None]
            torch.cuda.synchronize(dev)
            decode_s = time.perf_counter() - t
            toks = ex.generate_greedy(prompt, NEW_TOKENS)
            with _PlainKernels():
                plain = ex.generate_greedy(prompt, NEW_TOKENS)
            report = {"prefill_s": prefill_s,
                      "decode_tok_s": (NEW_TOKENS - 1) / decode_s,
                      "ms_per_layer_per_decode_step":
                          decode_s * 1e3 / (NEW_TOKENS - 1) / cfg.n_layers,
                      "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "tokens": toks[0].tolist()}
            log(f"[zoo-rec] {arch} batch 1: {json.dumps(report)}")
            if not (toks == plain).all():
                fail(f"[zoo-rec] {arch} batch 1: the run differs from the one "
                     f"with the plain versions (it runs no kernel)")
            del ex, state
            layouts = ({},)
        else:
            layouts = ({}, dict(kv_page=None, prefill_chunk=REC_CHUNK))
        for lay in layouts:
            _, launches = _zoo_serve(f"{arch} plain", None, cfg, params, dev,
                                     tag="zoo-rec", **lay)
            _add(total, launches)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------
# the encoder-decoder (ROADMAP item 6, sub-item 4)
WHISPER = "whisper-medium"
WHISPER_CHUNK = 32  # [whisper]'s dense-slot admission chunk
WHISPER_LAYERS = 8  # [whisper]'s encoder and decoder depth (the time limit)


def phase_whisper_parity(dev):
    """whisper at ``reduced()`` size in f32 (2 + 2 layers, d 256, 4 / 4 x
    64, 24 frames), card (kernels) against CPU (plain versions), weights
    from seed 0 with random norm scales and biases, a seeded frontend per
    request, exactly equal: ``generate_plain`` tokens; the plain
    ``ContinuousEngine`` (4 requests through 2 slots: tokens and emit
    steps) on pages, on dense slots with chunks of 4, and draft-and-verify
    with an f32 ``tiny-draft`` (k = 2) on dense slots and on pages.
    Returns the card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import generate_plain
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    total = {}
    cfg = get_config(WHISPER).reduced()
    dcfg = get_config("tiny-draft").replace(dtype="float32")
    dparams = T.init_model(dcfg, seed=1, device="cpu")
    params = _random_norms(T.init_model(cfg, seed=0, device="cpu"), 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 11, 8, 14)]
    news = (8, 5, 7, 4)
    audio = _frontends(cfg, len(prompts))
    runs = {}
    for where in ("cpu", dev):
        ops.reset_launches()
        p = _to(params, where)
        one = {"audio_embeds": audio[1]["audio_embeds"][None]}
        r = {"generate_plain": generate_plain(
            p, cfg, prompts[1][None], 8, extras=one, device=where).tolist()}
        spec = dict(draft_params=_to(dparams, where), draft_cfg=dcfg,
                    num_draft_tokens=2)
        for variant, kw in (("paged", {}),
                            ("dense_chunked", dict(kv_page=None, prefill_chunk=4)),
                            ("dense_spec", dict(kv_page=None, **spec)),
                            ("paged_spec", spec)):
            _, toks, steps, _ = _serve(None, cfg, prompts, news, max_slots=2,
                                       slot_len=64, params=p, device=where,
                                       extras=audio, **kw)
            r[variant] = (toks, steps)
        runs[str(where)] = r
        if where != "cpu":
            _add(total, ops.launches())
    card, cpu = runs[str(dev)], runs["cpu"]
    log(f"[whisper-parity] {WHISPER} reduced ({cfg.n_layers} + "
        f"{cfg.encoder_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, {cfg.encoder_seq} frames): card == "
        f"cpu {card == cpu} on {sorted(card)}; card launches {total}; "
        f"{time.perf_counter() - t0:.1f} s")
    if card != cpu:
        fail(f"[whisper-parity] the card differs from the CPU: {card} vs {cpu}")
    if not (total.get("flash_attention") and total.get("ragged_attention")):
        fail(f"[whisper-parity] the card ran no flash or ragged kernel: {total}")
    return total


def phase_whisper(dev):
    """whisper-medium at its published widths, depth cut to
    ``WHISPER_LAYERS`` encoder and decoder layers of 24 + 24 (the script's
    time limit; ``[cli]`` serves it at full depth), d 1024, 16 / 16 heads
    x 64, 1500 frames, vocab 51865, in bf16, random weights from seed 0, a
    seeded stub frontend per request: ``[serve]``'s 8 requests through 4
    slots on pages of 16 and on dense slots with chunks of 32
    (``_zoo_serve``: tokens/s, encoder, admission and decode seconds, ms
    per layer per decode step, peak memory, launches by route against the
    expected, the encoder-KV bytes per row against ``enc_kv_bytes``; held
    to the plain versions by the near-tie rule).  Returns the launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER).replace(n_layers=WHISPER_LAYERS,
                                      encoder_layers=WHISPER_LAYERS)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    n = T.count_params_analytic(cfg)
    log(f"[whisper] {WHISPER}: {cfg.encoder_layers} + {cfg.n_layers} of 24 + 24 "
        f"layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
        f"{cfg.encoder_seq} frames, {n / 1e9:.3f}B parameters ({n * 2 / 2**30:.2f} "
        f"GiB bf16) drawn in {time.perf_counter() - t0:.1f} s")
    total = {}
    for lay in ({}, dict(kv_page=None, prefill_chunk=WHISPER_CHUNK)):
        _, launches = _zoo_serve(f"{WHISPER} plain", None, cfg, params, dev,
                                 tag="whisper", **lay)
        _add(total, launches)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------
PHASE_S = {}  # wall seconds of each phase, for the [phases] line
T_START = time.perf_counter()


def _phase(label, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall seconds added to ``PHASE_S[label]``."""
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PHASE_S[label] = PHASE_S.get(label, 0.0) + time.perf_counter() - t0


def main():
    card = _phase("device", phase_device)
    import torch
    from repro_torch.benchmarks import kernels_bench as KB
    dev = torch.device("cuda", 0)
    kern, tiers, flush = _phase("kernels", phase_kernels, dev)
    _phase("parity", phase_parity, dev)
    _phase("continuous-parity", phase_continuous_parity, dev)
    _phase("plain-parity", phase_plain_parity, dev)
    serve_extra = _phase("serve-plain-parity", phase_serve_plain_parity, dev)
    _add(serve_extra, _phase("serve-bench", phase_serve_bench, dev))
    _phase("bf16-parity", phase_bf16_parity, dev)
    _phase("spec-parity", phase_spec_parity, dev)
    item5 = _phase("item5-parity", phase_item5_parity, dev)
    _add(item5, _phase("f4", phase_f4, dev))
    _add(item5, _phase("zoo-parity", phase_zoo_parity, dev))
    _add(item5, _phase("rec-parity", phase_rec_parity, dev))
    _add(item5, _phase("whisper-parity", phase_whisper_parity, dev))
    _phase("train", phase_train, dev)
    launches, batches, eng, cfg, prompt, main_run, main_report = _phase(
        "main", phase_main, dev)
    # the host-bound decode runs come before any profiler window
    planes = _phase("planes", phase_planes, dev, eng, cfg)
    launches["dequant_matmul"] = planes["pr2_sync"]["launches"]["dequant_matmul"]
    spec_launches = _phase("spec", phase_spec, dev, eng, cfg)
    accounting, dense = _phase("accounting", phase_accounting, dev, eng, cfg,
                               prompt, main_run)
    launches["flash_attention"] += accounting["flash_attention"]
    _add(serve_extra, _phase("serve-plain", phase_serve_plain, dev, eng, cfg, dense))
    del dense
    torch.cuda.empty_cache()
    decode_split = _phase("profile", _profile_decode, eng, prompt, dev)
    _phase("prefill-profile", _profile_prefill, eng, prompt, dev)
    batched, _ = _phase("prefill-kernel", KB.grouped_cases, dev, tiers,
                        flush, batches)
    batched["max_abs_err"] = max(batched["max_abs_err"],
                                 kern["dequant_matmul_batched"]["max_abs_err"])
    kern["dequant_matmul_batched"] = batched
    del tiers, flush
    serve_launches, serve_slots, serve_toks = _phase("serve", phase_serving,
                                                     dev, eng, cfg)
    item7 = _phase("telemetry", phase_telemetry, dev, eng, cfg, serve_toks,
                   prompt, main_run[0])
    _add(spec_launches, _phase("spec-serve", phase_spec_serve, dev, eng, cfg,
                               serve_toks))
    # prefix cache, host swap with preemption, the fault plane
    _add(item5, _phase("prefix", phase_prefix, dev, eng, cfg))
    _add(item5, _phase("preempt", phase_preempt, dev, eng, cfg, serve_toks))
    _add(item5, _phase("chaos", phase_chaos, dev, eng, cfg))
    launches["ragged_attention"] = serve_launches["ragged_attention"]
    slots = kern["dequant_matmul_slots"]
    slots["max_abs_err"] = max(slots["max_abs_err"], serve_slots["err"])
    paper = _phase("paper", phase_paper, dev, eng, cfg, main_report, planes,
                   decode_split, kern)
    for name, n in paper.items():
        launches[name] += n
    _add(item7, _phase("attention-bench", phase_attention_bench, dev))
    del eng
    zoo = _phase("zoo", phase_zoo, dev)
    _add(zoo, _phase("zoo-rec", phase_zoo_rec, dev))
    _add(zoo, _phase("whisper", phase_whisper, dev))
    _phase("cli", phase_cli, dev)
    _phase("dryrun", phase_dryrun, card)
    for name in launches:  # [zoo], [zoo-rec], [whisper]
        launches[name] += zoo.get(name, 0)
    for name in ("ragged_attention", "flash_attention", "dequant_matmul_slots",
                 "dequant_matmul_batched"):
        launches[name] += serve_extra.get(name, 0)
    for name in launches:  # the draft-and-verify paths ([spec], [spec-serve])
        launches[name] += spec_launches.get(name, 0)
    for name in launches:  # [item5-parity], [f4], [zoo-parity], [rec-parity],
        # [whisper-parity], [prefix], [preempt], [chaos]
        launches[name] += item5.get(name, 0)
    for name in launches:  # [telemetry], [attention-bench]
        launches[name] += item7.get(name, 0)
    phases = {k: round(v, 2) for k, v in PHASE_S.items()}
    phases["total"] = round(time.perf_counter() - T_START, 2)
    log(f"[phases] wall seconds: {json.dumps(phases)}")
    csrc = "src/repro_torch/kernels/csrc/"
    src = {"dequant_matmul_batched": csrc + "dequant_grouped.cu",
           "dequant_matmul_slots": csrc + "dequant_gemv.cu",
           "dequant_matmul": csrc + "dequant_gemv.cu",
           "flash_attention": csrc + "flash_attention.cu",
           "ragged_attention": csrc + "ragged_mma.cu"}
    replaces = {"dequant_matmul_batched": "src/repro/kernels/dequant_matmul.py:109",
                "dequant_matmul_slots": "src/repro/kernels/dequant_matmul.py:145",
                "dequant_matmul": "src/repro/kernels/dequant_matmul.py:57",
                "flash_attention": "src/repro/kernels/flash_attention.py:92",
                "ragged_attention": "src/repro/kernels/ragged_attention.py:206"}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": src[n], "replaces": replaces[n],
         "launches": launches[n], "max_abs_err": kern[n]["max_abs_err"],
         "ms": kern[n]["ms"], "plain_ms": kern[n]["plain_ms"],
         "bound_ms": kern[n]["bound_ms"], "bound_by": kern[n]["bound_by"],
         "library_ms": kern[n].get("library_ms")} for n in src]}
    if any(k["launches"] < 1 for k in line["kernels"]):
        fail(f"a kernel was not launched on its path: {line}")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
