"""Kernel benchmarks of the port (the counterpart of the reference's
``benchmarks/kernels_bench.py``): the one module that checks and times
every hand-written kernel behind ``kernels/ops.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only kernels [--quick] [--device cpu]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench [--quick] [--device cpu]

Two groups of cases.

a. The reference's rows at its shapes, in float32 (:func:`reference_rows`):
   the 2-D dequant-matmul at 2, 4 and 8 bits (groups of 64, the scheme's
   meta groups), causal flash attention, and the model's chunked
   ``attention_core``.  The reference's ``*_ref_*_jit`` rows are the
   port's ``*_plain_*`` rows (the plain PyTorch versions); its
   ``*_pallas_interp`` rows are the port's ``*_cuda_*`` rows, which launch
   the kernel and so run on the card only, each held to its plain version
   before it is timed.  ``derived`` carries GFLOP/s as the reference's
   does; :func:`common.timeit` times every row.  On the CPU only the plain
   rows run (with ``quick`` as without), as the reference's ``--smoke``
   runs only its jnp paths.
b. On the card only: every case the kernel phases of ``chip_smoke.py``
   check and time.  The three
   dequant bindings at Mixtral's expert shapes (4096 x 14336, 14336 x
   4096) at 2 and 3 bits: slots at B = 2, batched at B = 8 x 16 rows, the
   2-D binding at one row, each beside the FMA kernel the decode bindings
   ran before; ``tiny-moe``'s float32 shapes; the slot binding at the
   verify chunks' B = 10 and 40 rows (:func:`dequant_cases`).  The
   grouped binding at given per-expert row counts and at 8192 rows over 8
   experts (:func:`grouped_cases`).  Ragged and flash attention at
   Mixtral's, phi-3's (head_dim 96), recurrentgemma's (256) and
   whisper's shapes, the ragged kernel beside the warp kernel it replaced
   and flash beside ``scaled_dot_product_attention`` where no window cuts
   the case (:func:`attention_cases`).

Each group (b) case is checked against its plain version on the same
card tensors, then each launch is timed alone behind a spin kernel after
a 128 MiB L2 flush (:func:`event_ms`: the main path finds its weights
cold).  It gives one record: the kernel's max error and the tolerance it
was held to, the route it took, kernel, plain and (where one exists)
previous-kernel and SDPA ms, and the bound: the larger of the bytes the
function must move over the memory rate and its operations over the peak
rate of their type, from :func:`dequant_work`, :func:`grouped_work`,
:func:`flash_work` and :func:`ragged_work`, functions of the case's shapes.

Nothing falls back to the plain version.  A kernel that fails to build
or launch raises; an error over its tolerance, a non-finite output or a
bfloat16 case off its tensor-core route (GEMV, grouped, ``wgmma``,
``ragged_mma``) raises :class:`KernelCheckError`.  Rows and records go to
``experiments/torch/bench/kernels.json``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.quant import hqq

# the card's peaks (NVIDIA's data sheet, H100 SXM, dense): device memory,
# bf16 on the tensor cores (the inputs are bf16 activations and integer
# codes), float32 outside the tensor cores (group (a)'s float32 rows)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
KERNEL_RTOL = 1e-4          # of max |plain|: f32 sums over <= 14336 terms in another order
RAGGED_BF16_RTOL = 2 ** -7  # of each row's max |plain in f32|: the kernel
                            # accumulates in f32 and rounds only its bf16
                            # output, by at most 2^-8 of the value
FLASH_BF16_RTOL = 2 ** -7   # of each (head, row)'s max |plain in f32|: the
                            # same reason as the ragged kernel's
FLASH_F32_RTOL = 2e-5       # of each (head, row)'s max |plain|: the same
                            # f32 sums in another order
FLUSH_BYTES = 128 << 20     # overwritten before each timed launch (L2 is 50 MB)
CHUNK = 64                  # the main path's prefill chunk: chip_smoke.py's
                            # 64-token prompt (its PROMPT_LEN, checked there)

# group (a): the reference's shapes (benchmarks/kernels_bench.py)
REF_BITS = (2, 4, 8)
REF_GROUP = 64


def ref_shapes(quick):
    """(M, K, N) of the dequant rows, (BH, BKV, S, d) of flash, and (B, S,
    Hkv, G, hd) of the model's chunked attention."""
    return ((32, 256, 128) if quick else (64, 1024, 512),
            (4, 2, 256, 64) if quick else (8, 2, 1024, 64),
            (2, 512, 2, 2, 64))


# group (b): Mixtral's experts (gate, down, up) and the bindings' batches
SHAPES = ((4096, 14336), (14336, 4096), (4096, 14336))
DEQUANT_CASES = {"dequant_matmul_slots": dict(B=2, M=1, S=4),
                 "dequant_matmul_batched": dict(B=8, M=16, S=8),
                 "dequant_matmul": dict(B=1, M=1, S=1)}
DEQUANT_BITS = (2, 3)
TINY_SHAPES = ((256, 512), (512, 256))  # tiny-moe's experts, 3-bit, f32 x
VERIFY_ROWS = (10, 40)  # C x top_k rows of one k = 4 chunk, and of four rows'
LONG_PROMPT = 4096      # the grouped case's prompt: x top-2 routed rows over 8

# attention: (H, Hkv, hd), ragged cases (name, live lengths, C), flash
# cases (name, Sq, Skv, q_offset, window[, causal, batch]), per model
MIXTRAL_HEADS = (32, 8, 128)
MIXTRAL_WINDOW = 4096
RAGGED_CASES = (("decode", [37, 300, 1500, 4200], 1),
                ("admission", [200], 128),
                # four serving rows' verify chunks (k = 4)
                ("verify", [69, 133, 1500, 4200], 5))
FLASH_CASES = (
    ("prefill_chunk", CHUNK, CHUNK, 0, MIXTRAL_WINDOW),
    ("long_prompt", 4096, 4096, 0, None),
    ("windowed", 1024, 8192, 7168, MIXTRAL_WINDOW),
    ("verify_chunk", 5, CHUNK + 5, CHUNK, MIXTRAL_WINDOW),  # a C = 5 chunk
)
PHI3_HEADS = (32, 32, 96)  # phi-3-vision: H, Hkv, head_dim
PHI3_FLASH = (("prefill_chunk", CHUNK, CHUNK, 0, None),)
PHI3_RAGGED = (("decode", [64, 300, 1500, 4000], 1),)
RG_HEADS = (16, 1, 256)  # recurrentgemma-9b: H, Hkv (MQA), head_dim
RG_WINDOW = 2048
RG_FLASH = (("prefill_chunk", CHUNK, CHUNK, 0, RG_WINDOW),
            ("windowed", 1024, 2048, 1024, RG_WINDOW),
            ("verify_chunk", 5, CHUNK + 5, CHUNK, RG_WINDOW))
RG_RAGGED = (("decode", [64, 300, 1500, 4000], 1), ("admission", [128], 128))
WHISPER_HEADS = (16, 16, 64)  # H, Hkv, head_dim
WHISPER_FLASH = (
    ("prefill_chunk", CHUNK, CHUNK, 0, None, True, 1),
    ("encoder", 1500, 1500, 0, None, False, 1),
    ("cross_decode", 1, 1500, 0, None, False, 4),
    ("cross_chunk", CHUNK, 1500, 0, None, False, 1))
WHISPER_RAGGED = (("decode", [64, 300, 1500, 4000], 1), ("admission", [128], 128))
# (label suffix, heads, ragged cases, ragged window, flash cases), in run order
ATTENTION_MODELS = (("", MIXTRAL_HEADS, RAGGED_CASES, MIXTRAL_WINDOW, FLASH_CASES),
                    ("-hd96", PHI3_HEADS, PHI3_RAGGED, None, PHI3_FLASH),
                    ("-hd256", RG_HEADS, RG_RAGGED, RG_WINDOW, RG_FLASH),
                    ("-whisper", WHISPER_HEADS, WHISPER_RAGGED, None, WHISPER_FLASH))
PAGE = 16
# each binding's case on the main path: its record is the kernels line's entry
MAIN_CASES = {"dequant_matmul_batched": "dequant_matmul_batched_2bit",
              "dequant_matmul_slots": "dequant_matmul_slots_2bit",
              "dequant_matmul": "dequant_matmul_2bit",
              "ragged_attention": "ragged_decode",
              "flash_attention": "flash_prefill_chunk"}


class KernelCheckError(RuntimeError):
    """A kernel disagreed with its plain version, gave a non-finite value,
    or left its route."""


def log(*a):
    print(*a, flush=True)


def _fail(msg):
    raise KernelCheckError(msg)


# ----------------------------------------------------------------------
# work and bound: functions of a case's shapes
def record_bytes(K, N, bits, group_size=None) -> int:
    """Stored bytes of one (K, N) weight as ``hqq.quantize`` lays it out
    with the scheme's meta groups: the packed codes, the 8-bit scale and
    zero, and their four f16 meta leaves."""
    scheme = hqq.PAPER_SCHEMES[bits]
    gs = group_size or scheme["group_size"]
    G = K // gs
    sg = hqq.meta_group(G, scheme["scale_group"])
    return G * (gs * bits // 8) * N + 2 * G * N + 4 * 2 * (G // sg) * N


def dequant_work(rows, K, N, bits, records, x_bytes=2, group_size=None):
    """(bytes, operations) of ``rows`` rows of x against ``records``
    distinct stored (K, N) records: each record once, x once, the float32
    output once; 2 K N operations a row."""
    nbytes = (records * record_bytes(K, N, bits, group_size)
              + rows * K * x_bytes + rows * N * 4)
    return nbytes, 2 * rows * K * N


def dequant_layer_work(name, bits):
    """(bytes, operations) of one of :data:`DEQUANT_CASES` over the three
    matrices of a MoE layer (of one (token, k) expert for the 2-D one)."""
    c = DEQUANT_CASES[name]
    work = [dequant_work(c["B"] * c["M"], K, N, bits, c["B"]) for K, N in SHAPES]
    return tuple(map(sum, zip(*work)))


def grouped_work(counts, bits=2):
    """(bytes, operations) of the grouped binding over len(counts) records
    with ``counts`` rows each, for gate, down and up."""
    rows = int(sum(counts))
    work = [dequant_work(rows, K, N, bits, len(counts)) for K, N in SHAPES]
    return tuple(map(sum, zip(*work)))


def flash_work(Sq, Skv, q_offset, window, H, Hkv, hd, causal=True, B=1,
               elem=2):
    """(bytes, operations) the function must move and do over B rows: q
    and out once, the K/V rows some query can see once; 2 x 2 x hd
    operations per valid (query head, query, key)."""
    qpos = q_offset + np.arange(Sq)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(0, qpos - window + 1)
    hi = np.minimum(Skv, qpos + 1) if causal else np.full(Sq, Skv)
    pairs = int(np.maximum(hi - lo, 0).sum())
    keys = int(hi.max() - lo.min())
    nbytes = 2 * H * Sq * hd * elem + 2 * Hkv * keys * hd * elem
    return B * nbytes, B * 4 * hd * H * pairs


def paged_layout(lens, C, ps=PAGE):
    """Host page tables for rows of live lengths ``lens``, their pages
    scattered over a pool of 8 spare pages (a permutation seeded by the
    pool's size), queries at the last C positions: (pages (B, T), ppos
    (P, ps), qpos (B, C)), int32."""
    B = len(lens)
    T = max(-(-n // ps) for n in lens)
    P = sum(-(-n // ps) for n in lens) + 8
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(P)).tolist()
    pages = np.full((B, T), -1, np.int32)
    ppos = np.full((P, ps), -1, np.int32)
    for b, n in enumerate(lens):
        for o in range(-(-n // ps)):
            pages[b, o] = pid = ids.pop()
            for j in range(min(ps, n - o * ps)):
                ppos[pid, j] = o * ps + j
    qpos = (np.asarray(lens)[:, None] - C + np.arange(C)).astype(np.int32)
    return pages, ppos, qpos


def ragged_work(lens, C, heads, window, ps=PAGE):
    """(bytes, operations, work list, pages visited) of a decode or chunk
    step over :func:`paged_layout`: each visited page's k, v (bf16) and
    ppos once, q and out once; q.k and p.v (2 x 2 x hd operations) on
    each valid key of each query head."""
    from repro_torch.kernels import ragged_attention as RA
    n_heads, n_kv, hd = heads
    pages, ppos, qpos = paged_layout(lens, C, ps)
    wl = RA.build_page_worklist(pages, lens, qpos[:, 0], qpos[:, -1], ps,
                                window=window)
    visited = int(wl[2][:, 2].sum())
    nbytes = visited * (2 * ps * n_kv * hd * 2 + ps * 4) + 2 * len(lens) * C * n_heads * hd * 2
    keys = sum(int(((0 <= kv) & (kv <= qp)
                    & (qp - kv < (window or np.inf))).sum())
               for b in range(len(lens)) for qp in qpos[b]
               for kv in [ppos[pages[b][pages[b] >= 0]].ravel()])
    return nbytes, 4 * n_heads * hd * keys, wl, visited


def bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over ``flop_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _with_bound(rec, flop_rate=BF16_FLOP_PER_S):
    """``rec`` with its ``bound_ms``, ``bound_by`` and ``bound_share``
    from its ``bytes`` and ``flops`` and its ``ms``."""
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"], flop_rate)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def stored_bytes(qt, n_slots):
    """Bytes of ``n_slots`` records of the stacked ``qt``, from its leaves."""
    return n_slots * sum(a[0].numel() * a.element_size()
                         for _, a in hqq.leaves(qt))


# ----------------------------------------------------------------------
def new_flush(dev):
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)


def event_ms(fn, n, flush):
    """Mean device time of ``fn``, each launch timed alone after the L2
    cache is overwritten (the main path finds its weights cold).  A spin
    kernel ahead of the start event keeps the host's launch overhead out
    of the interval."""
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


# ----------------------------------------------------------------------
# group (a): the reference's rows
def reference_inputs(quick=False):
    """Group (a)'s inputs as float32 numpy arrays, each from its own
    seeded generator: w, x (dequant), q, k, v (flash), qq, kk, vv (the
    model's chunked attention)."""
    (M, K, N), (BH, BKV, S, d), (B, S2, Hkv, G, hd) = ref_shapes(quick)
    rnd = lambda seed, *shape: np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)
    return dict(w=rnd(0, K, N) * np.float32(0.05), x=rnd(1, M, K),
                q=rnd(2, BH, S, d), k=rnd(3, BKV, S, d), v=rnd(4, BKV, S, d),
                qq=rnd(5, B, S2, Hkv * G, hd), kk=rnd(6, B, S2, Hkv, hd),
                vv=rnd(7, B, S2, Hkv, hd))


def _gflops(flops, us):
    return f"gflops={flops / us / 1e3:.2f}"


def _scale_check(y, yp):
    """(max |y - yp|, that over ``KERNEL_RTOL`` x max |yp|)."""
    err = (y - yp).abs().max().item()
    return err, err / (KERNEL_RTOL * yp.abs().max().item())


def _kernel_row(name, fn, plain, args, flops, work, check, flush):
    """A ``*_cuda_*`` row: the kernel checked against its plain version
    (``check(y, yp) -> (max_abs_err, largest error over its tolerance)``),
    then timed twice: ``us_per_call`` by :func:`common.timeit` (warm calls,
    the host path included, as the reference's rows), ``ms`` one launch
    alone by :func:`event_ms`, the figure held against the bound of
    ``work`` (bytes, operations).  ``flops`` is the reference's count for
    ``derived``; ``route`` names the routes its launch counted."""
    from repro_torch.kernels import ops
    before = ops.routes()
    y, yp = fn(*args), plain(*args)
    torch.cuda.synchronize()
    route = ",".join(k for k, v in ops.routes().items() if v != before[k])
    if not bool(torch.isfinite(y).all()):
        _fail(f"{name}: non-finite output")
    err, over = check(y, yp)
    if not over <= 1.0:
        _fail(f"{name}: max |kernel - plain| {err:.3g} is {over:.3g} times "
              f"its tolerance")
    us, _ = common.timeit(fn, *args)
    ms = event_ms(lambda: fn(*args), 20, flush)
    bound_ms, bound_by = bound(*work, F32_FLOP_PER_S)
    return {"name": name, "us_per_call": f"{us:.1f}",
            "derived": _gflops(flops, us), "route": route,
            "max_abs_err": err, "max_err_over_tolerance": over, "ms": ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


@torch.no_grad()
def reference_rows(device=None, quick=False):
    """Group (a) on ``device`` (the card unless ``"cpu"``): the plain rows
    everywhere, the kernel rows on the card."""
    from repro_torch.kernels import flash_attention as FA, ops, ref
    from repro_torch.models.layers import attention_core
    dev = resolve_device(device)
    card = dev.type == "cuda"
    flush = new_flush(dev) if card else None
    a = {k: torch.from_numpy(v).to(dev) for k, v in reference_inputs(quick).items()}
    (M, K, N), (BH, BKV, S, d), (B, S2, Hkv, G, hd) = ref_shapes(quick)
    rows = []
    for bits in REF_BITS:
        qt = hqq.quantize(a["w"], bits, group_size=REF_GROUP, scale_group=None)
        flops = 2 * M * K * N
        plain = lambda xx, qt=qt: ref.dequant_matmul(xx, qt)
        us, _ = common.timeit(plain, a["x"])
        rows.append({"name": f"dequant_matmul_plain_{bits}bit",
                     "us_per_call": f"{us:.1f}", "derived": _gflops(flops, us)})
        if card:
            rows.append(_kernel_row(
                f"dequant_matmul_cuda_{bits}bit",
                lambda xx, qt=qt: ops.dequant_matmul(xx, qt), plain, (a["x"],),
                flops, dequant_work(M, K, N, bits, 1, x_bytes=4, group_size=REF_GROUP),
                _scale_check, flush))
    flops = 4 * BH * S * S * d  # the reference's count: the full square
    plain = lambda q, k, v: FA.flash_attention_reference(q, k, v, causal=True)
    us, _ = common.timeit(plain, a["q"], a["k"], a["v"])
    rows.append({"name": "flash_attention_plain", "us_per_call": f"{us:.1f}",
                 "derived": _gflops(flops, us)})
    if card:
        def check(y, yp):  # each (head, row) within FLASH_F32_RTOL of its own max
            err = (y - yp).abs().amax(-1)
            return err.max().item(), (err / (FLASH_F32_RTOL * yp.abs().amax(-1))).max().item()
        rows.append(_kernel_row(
            "flash_attention_cuda",
            lambda q, k, v: ops.flash_attention(q, k, v, causal=True), plain,
            (a["q"], a["k"], a["v"]), flops,
            flash_work(S, S, 0, None, BH, BKV, d, elem=4), check, flush))
    pos = torch.arange(S2, dtype=torch.int32, device=dev)
    us, _ = common.timeit(lambda q, k, v: attention_core(
        q, k, v, pos, pos, causal=True, window=None), a["qq"], a["kk"], a["vv"])
    rows.append({"name": "model_chunked_attention", "us_per_call": f"{us:.1f}",
                 "derived": f"B{B}xS{S2}xH{Hkv * G}"})
    for r in rows:
        r["device"] = str(dev)
    return rows


# ----------------------------------------------------------------------
# group (b): the kernel phases' cases, on the card
def dequant_cases(dev, flush):
    """Each binding at the main path's shapes: decode (``slots``: B = 2
    rows, M = 1, over a pool of 4 slots), prefill (``batched``: B = 8
    distinct experts, M = 16 rows each) and the unrolled plane's decode
    (the 2-D ``dequant_matmul``: one row, M = 1, against one record of
    a stack, read in place); gate/up (4096 x 14336) and down (14336 x
    4096); x bf16; 2- and 3-bit codes; then ``tiny-moe``'s float32 shapes
    and the slot binding at the verify rows.  A record's figures are
    summed over the three matrices: of a MoE layer for the 3-D bindings,
    of one (token, k) expert for the 2-D one.  Returns (the records, the
    8-expert tiers by (bits, K, N) for :func:`grouped_cases`)."""
    from repro_torch.kernels import dequant_matmul as DM, ops, ref
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    records = []
    tiers = {}
    for bits in DEQUANT_BITS:
        for K, N in sorted(set(SHAPES)):
            w = torch.randn((8, K, N), generator=gen, device=dev) * 0.02
            tiers[bits, K, N] = hqq.quantize(w.to(torch.bfloat16), bits)
            del w
    for bits in DEQUANT_BITS:
        for name, c in DEQUANT_CASES.items():
            rec = dict(name=f"{name}_{bits}bit", binding=name, ms=0.0,
                       plain_ms=0.0, bytes=0, flops=0, max_abs_err=0.0,
                       max_rel_err=0.0, rtol=KERNEL_RTOL)
            for K, N in SHAPES:
                qt = tiers[bits, K, N]
                if 1 < c["S"] < 8:
                    qt = hqq.QTensor(qt.packed[:c["S"]], qt.scale[:c["S"]],
                                     qt.zero[:c["S"]],
                                     {k: v[:c["S"]] for k, v in qt.meta.items()},
                                     bits, qt.group_size, (c["S"], K, N))
                x = torch.randn((c["B"], c["M"], K), generator=gen,
                                device=dev).to(torch.bfloat16)
                previous = None  # the FMA kernel, what the binding ran before
                if name == "dequant_matmul":
                    x, qt = x[0], hqq.slice_leading(tiers[bits, K, N], 5)
                    run = lambda: ops.dequant_matmul(x, qt)
                    plain = lambda: ref.dequant_matmul(x, qt)
                    stack = ref.stack_one(qt)
                    previous = lambda: DM._launch_fma(x[None], stack, None)[0]
                    route_key, want = "gemv", "gemv"
                elif name == "dequant_matmul_slots":
                    slots = torch.tensor([3, 1], dtype=torch.int32, device=dev)
                    run = lambda: ops.dequant_matmul_slots(x, qt, slots)
                    plain = lambda: ref.dequant_matmul_slots(x, qt, slots)
                    previous = lambda: DM._launch_fma(x, qt, slots)
                    route_key, want = "gemv", "gemv"
                else:
                    run = lambda: ops.dequant_matmul_batched(x, qt)
                    plain = lambda: ref.dequant_matmul_batched(x, qt)
                    route_key, want = "grouped", "grouped"
                routes = (DM.launch_grouped if name == "dequant_matmul_batched"
                          else DM.launch).routes
                n0 = routes[route_key]
                y, yp = run(), plain()
                torch.cuda.synchronize()
                if routes[route_key] != n0 + 1:
                    _fail(f"{name} {bits}-bit K={K} N={N}: bfloat16 x did not "
                          f"take the tensor-core route ({want})")
                err = (y - yp).abs().max().item()
                scale = yp.abs().max().item()
                if not (err <= KERNEL_RTOL * scale) or not torch.isfinite(y).all():
                    _fail(f"{name} {bits}-bit K={K} N={N}: max |kernel - plain| "
                          f"{err:.3g} > {KERNEL_RTOL} x {scale:.3g}")
                ms = event_ms(run, 20, flush)
                pms = event_ms(plain, 3, flush)
                nbytes, flops = dequant_work(c["B"] * c["M"], K, N, bits, c["B"])
                prev = ""
                if previous is not None:
                    perr = (previous() - yp).abs().max().item()
                    if not perr <= KERNEL_RTOL * scale:
                        _fail(f"previous {name} kernel {bits}-bit K={K}: {perr:.3g}")
                    prev_ms = event_ms(previous, 20, flush)
                    prev = f" previous (FMA) kernel {prev_ms:.4f} ms err {perr:.3g}"
                    rec["previous_ms"] = rec.get("previous_ms", 0.0) + prev_ms
                    rec["previous_max_abs_err"] = max(
                        rec.get("previous_max_abs_err", 0.0), perr)
                log(f"[kernel] {name} {bits}-bit B={c['B']} M={c['M']} K={K} "
                    f"N={N}: max_abs_err {err:.3g} (max |y| {scale:.3g}) "
                    f"kernel {ms:.4f} ms plain {pms:.4f} ms{prev} "
                    f"bytes {nbytes} -> {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
                rec.update(route=want, ms=rec["ms"] + ms,
                           plain_ms=rec["plain_ms"] + pms,
                           bytes=rec["bytes"] + nbytes, flops=rec["flops"] + flops,
                           max_abs_err=max(rec["max_abs_err"], err),
                           max_rel_err=max(rec["max_rel_err"], err / scale))
            records.append(_with_bound(rec))
    # tiny-moe's own shapes (3-bit, g = 64, float32 x) through the three bindings
    for K, N in TINY_SHAPES:
        w = torch.randn((8, K, N), generator=gen, device=dev) * 0.05
        qt = hqq.quantize(w, 3)
        x = torch.randn((8, 4, K), generator=gen, device=dev)
        slots = torch.tensor([7, 0, 3, 3, 5, 1, 2, 6], dtype=torch.int32, device=dev)
        q2 = hqq.slice_leading(qt, 6)
        distinct = len(set(slots.tolist()))
        calls = {"dequant_matmul_slots": (
                     (lambda: ops.dequant_matmul_slots(x, qt, slots)),
                     (lambda: ref.dequant_matmul_slots(x, qt, slots)), 32, distinct),
                 "dequant_matmul_batched": (
                     (lambda: ops.dequant_matmul_batched(x, qt)),
                     (lambda: ref.dequant_matmul_batched(x, qt)), 32, 8),
                 "dequant_matmul": (
                     (lambda: ops.dequant_matmul(x[3], q2)),
                     (lambda: ref.dequant_matmul(x[3], q2)), 4, 1)}
        outs = {name: (run(), plain()) for name, (run, plain, _, _) in calls.items()}
        for name, (run, plain, rows, n_rec) in calls.items():
            y, yp = outs[name]
            err = (y - yp).abs().max().item()
            scale = yp.abs().max().item()
            if not err <= KERNEL_RTOL * scale or not torch.isfinite(y).all():
                _fail(f"{name} tiny-moe shape K={K} N={N}: {err:.3g}")
            nbytes, flops = dequant_work(rows, K, N, 3, n_rec, x_bytes=4)
            records.append(_with_bound(dict(
                name=f"{name}_tiny_moe_{K}x{N}", binding=name, route="fma",
                ms=event_ms(run, 20, flush), plain_ms=event_ms(plain, 3, flush),
                bytes=nbytes, flops=flops, max_abs_err=err,
                max_rel_err=err / scale, rtol=KERNEL_RTOL), F32_FLOP_PER_S))
    # the slot binding at verify-chunk shapes: C x top_k rows of one k = 4
    # chunk (B = 10) and of four serving rows' chunks (B = 40), 2-bit, the
    # rows spread over the 8-record tier
    for B in VERIFY_ROWS:
        v = dict(name=f"dequant_matmul_slots_verify_B{B}",
                 binding="dequant_matmul_slots", route="gemv", B=B, ms=0.0,
                 plain_ms=0.0, bytes=0, flops=0, max_abs_err=0.0,
                 max_rel_err=0.0, rtol=KERNEL_RTOL)
        slots = torch.randint(0, 8, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        distinct = len(set(slots.tolist()))
        for K, N in SHAPES:
            qt = tiers[2, K, N]
            x = torch.randn((B, 1, K), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda: ops.dequant_matmul_slots(x, qt, slots)
            plain = lambda: ref.dequant_matmul_slots(x, qt, slots)
            gemv = DM.launch.routes["gemv"]
            y, yp = run(), plain()
            torch.cuda.synchronize()
            err, scale = (y - yp).abs().max().item(), yp.abs().max().item()
            if DM.launch.routes["gemv"] != gemv + 1:
                _fail(f"dequant_matmul_slots B={B}: not on the tensor-core GEMV")
            if not (err <= KERNEL_RTOL * scale) or not torch.isfinite(y).all():
                _fail(f"dequant_matmul_slots B={B} K={K} N={N}: max |kernel - "
                      f"plain| {err:.3g} > {KERNEL_RTOL} x {scale:.3g}")
            v["ms"] += event_ms(run, 20, flush)
            v["plain_ms"] += event_ms(plain, 3, flush)
            nbytes, flops = dequant_work(B, K, N, 2, distinct)
            v["bytes"] += nbytes
            v["flops"] += flops
            v["max_abs_err"] = max(v["max_abs_err"], err)
            v["max_rel_err"] = max(v["max_rel_err"], err / scale)
        log(f"[kernel] dequant_matmul_slots verify rows B={B}, per MoE layer "
            f"(3 matrices, 2-bit): {json.dumps(_with_bound(v))}")
        records.append(v)
    for name, e in entries(records).items():
        per = "(token, k) expert" if name == "dequant_matmul" else "MoE layer"
        log(f"[kernel] {name} per {per} (3 matrices, 2-bit): {json.dumps(e)}")
    return records, tiers


def _grouped_case(dev, tiers, flush, counts, gen, *, previous=False):
    """The batched binding over U = len(counts) experts of the 2-bit
    tiers with ragged row groups of ``counts`` rows, for gate, down and up,
    x bf16: checked against the plain version at ``KERNEL_RTOL`` and timed.
    With ``previous`` the FMA kernel (``csrc/dequant_matmul.cu``, what this
    binding launched before the grouped kernel) is timed beside it on the
    same rows zero-padded to the largest group.  The bound counts the U
    experts' stored bytes, x and the output, and the operations of the
    routed rows (:func:`grouped_work`)."""
    from repro_torch.kernels import dequant_matmul as DM, ops, ref
    U, rows = len(counts), int(sum(counts))
    off = np.concatenate([[0], np.cumsum(counts)])
    t = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0, err=0.0, rel=0.0)
    if previous:
        t["previous_padded_ms"] = 0.0
    for K, N in SHAPES:
        full = tiers[2, K, N]
        qt = hqq.QTensor(full.packed[:U], full.scale[:U], full.zero[:U],
                         {k: v[:U] for k, v in full.meta.items()},
                         2, full.group_size, (U, K, N))
        x = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
        grouped = DM.launch_grouped.routes["grouped"]
        y, yp = ops.dequant_matmul_batched(x, qt, off), ref.dequant_matmul_grouped(x, qt, off)
        err = (y - yp).abs().max().item()
        scale = yp.abs().max().item()
        if DM.launch_grouped.routes["grouped"] != grouped + 1:
            _fail(f"grouped at counts {list(counts)} K={K}: bfloat16 x did not "
                  f"take the grouped tensor-core kernel")
        if not (err <= KERNEL_RTOL * scale) or not torch.isfinite(y).all():
            _fail(f"grouped at counts {list(counts)} K={K}: {err:.3g} > "
                  f"{KERNEL_RTOL} x {scale:.3g}")
        t["err"], t["rel"] = max(t["err"], err), max(t["rel"], err / scale)
        t["ms"] += event_ms(lambda: ops.dequant_matmul_batched(x, qt, off), 10, flush)
        t["row_tile"] = DM.launch_grouped.last_bm
        del y, yp
        t["plain_ms"] += event_ms(lambda: ref.dequant_matmul_grouped(x, qt, off), 1, flush)
        if previous:
            xp = torch.zeros((U, int(max(counts)), K), dtype=x.dtype, device=dev)
            for u in range(U):
                xp[u, :counts[u]] = x[off[u]:off[u + 1]]
            t["previous_padded_ms"] += event_ms(lambda: DM._launch_fma(xp, qt, None), 5, flush)
    t["bytes"], t["flops"] = grouped_work(counts)
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
    t["tflop_s"] = t["flops"] / (t["ms"] * 1e-3) / 1e12
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def _grouped_record(name, t):
    return dict(name=name, binding="dequant_matmul_batched", route="grouped",
                max_abs_err=t["err"], max_rel_err=t["rel"], rtol=KERNEL_RTOL,
                **{k: v for k, v in t.items() if k not in ("err", "rel")})


def grouped_cases(dev, tiers, flush, batches=()):
    """The batched binding (the grouped tensor-core kernel) at ``batches``,
    one list of per-expert row counts per MoE layer (the main run's
    prefill passes its own), as ragged groups (no padding:
    ``padded_over_routed_rows`` is 1.0), gate, down and up at 2 bits, x
    bf16; the FMA kernel on the same rows padded to the largest group
    beside it (the previous design, same run).  Then one long case: a
    4096-token prompt's 8192 routed rows over 8 experts, counts from a
    seeded multinomial, operation-bound.  Returns the per-layer means
    (the kernels line's ``dequant_matmul_batched`` entry; the long case's
    figures when ``batches`` is empty) and the records, one a layer and the
    long case's)."""
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    per_layer, records = [], []
    for l, counts in enumerate(batches):
        t = _grouped_case(dev, tiers, flush, counts, gen, previous=True)
        log(f"[prefill-kernel] layer {l}: {len(counts)} experts, counts "
            f"{list(counts)}, row tile {t['row_tile']}: kernel {t['ms']:.4f} ms, "
            f"previous kernel padded {t['previous_padded_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        per_layer.append(t)
        records.append(_grouped_record(f"dequant_matmul_batched_layer{l}", t))
    counts = np.random.default_rng(8).multinomial(2 * LONG_PROMPT, [1 / 8] * 8)
    if per_layer:
        mean = lambda k: float(np.mean([t[k] for t in per_layer]))
        out = {"ms": mean("ms"), "previous_padded_ms": mean("previous_padded_ms"),
               "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
               "bound_by": per_layer[0]["bound_by"], "padded_over_routed_rows": 1.0,
               "max_abs_err": max(t["err"] for t in per_layer),
               "max_rel_err": max(t["rel"] for t in per_layer)}
        log(f"[prefill-kernel] per MoE layer, mean of {len(batches)}: {json.dumps(out)}")
    long = _grouped_case(dev, tiers, flush, [int(c) for c in counts], gen)
    log(f"[prefill-kernel] long prompt ({LONG_PROMPT} tokens x top-2 = "
        f"{2 * LONG_PROMPT} routed rows, counts {counts.tolist()}), per MoE "
        f"layer: {json.dumps(long)}")
    records.append(_grouped_record("dequant_matmul_batched_long", long))
    if not per_layer:
        out = {k: long[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        out["max_abs_err"], out["max_rel_err"] = long["err"], long["rel"]
    out["max_abs_err"] = max(out["max_abs_err"], long["err"])
    out["long"] = long
    return out, records


def _paged_case(dev, lens, C, gen, heads, window, ps=PAGE):
    """bf16 paged KV for rows of live lengths ``lens`` over
    :func:`paged_layout`, queries at the last C positions, with the work
    list and its bytes and operations (:func:`ragged_work`)."""
    from repro_torch.kernels import ragged_attention as RA
    n_heads, n_kv, hd = heads
    pages, ppos, qpos = paged_layout(lens, C, ps)
    nbytes, flops, wl, visited = ragged_work(lens, C, heads, window, ps)
    P = ppos.shape[0]
    kp = torch.randn((P, ps, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((P, ps, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((len(lens), C, n_heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    packed, n_seg = RA.pack_worklist(*wl, len(lens))
    work = RA.DeviceWorklist(torch.from_numpy(packed).to(dev), n_seg)
    return dict(q=q, kp=kp, vp=vp, ppos=torch.from_numpy(ppos).to(dev),
                pages=torch.from_numpy(pages).to(dev),
                qpos=torch.from_numpy(qpos).to(dev), work=work,
                window=window, nbytes=nbytes, flops=flops, visited=visited,
                listed=pages.size, segments=n_seg)


def ragged_cases(dev, flush, *, heads=MIXTRAL_HEADS, cases=RAGGED_CASES,
                 window=MIXTRAL_WINDOW, label="ragged"):
    """The ragged paged-attention kernel against its plain version, called
    through the binding the model path calls (``ops.ragged_attention``,
    which counts the launch): at Mixtral's shapes a decode step of 4 rows
    whose live lengths straddle the 4096 window (its pages wholly outside
    the window are skipped, the rest masked per key), a 128-token
    admission chunk and four rows' C = 5 verify chunks (draft-and-verify
    serving at k = 4); ``heads`` (H, Hkv, hd), ``cases`` and ``window``
    give another model's shapes (under ``label``).  Each row is held
    against the plain version run in f32 on the same (upcast) inputs,
    within ``RAGGED_BF16_RTOL`` of that row's own largest value; the
    kernel must take ``ragged_mma``.  The warp-reduction kernel it
    replaced is checked and timed beside it.
    ``scaled_dot_product_attention`` on the pre-gathered dense view is
    printed as a yardstick on its own line; the port never calls it.
    Returns the records, one a case."""
    from repro_torch.kernels import ops, ragged_attention as RA
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    records = []
    n_heads, n_kv, hd = heads
    for case, lens, C in cases:
        c = _paged_case(dev, lens, C, gen, heads, window)
        args = (c["q"], c["kp"], c["vp"], c["ppos"])
        run = lambda: ops.ragged_attention(*args, c["pages"], c["qpos"],
                                           window=c["window"],
                                           worklist=c["work"])
        plain = lambda: RA.ragged_attention_reference(
            *args, c["pages"], c["qpos"], window=c["window"])
        # the warp-reduction kernel, what the binding ran before
        previous = lambda: RA._launch_warp(*args, c["qpos"], c["work"],
                                           window=c["window"])
        before, mma = ops.ragged_attention.launches, RA.launch.routes["mma"]
        y = run()
        route = "mma" if RA.launch.routes["mma"] == mma + 1 else "warp"
        y32 = RA.ragged_attention_reference(  # the same sums in f32
            *(a.float() for a in args[:3]), c["ppos"], c["pages"], c["qpos"],
            window=c["window"])
        yprev = previous()
        torch.cuda.synchronize()
        if ops.ragged_attention.launches != before + 1:
            _fail(f"ragged_attention {case}: the binding did not count its launch")
        if route != "mma":
            _fail(f"ragged_attention {case}: bfloat16 took the {route} route, "
                  f"not the tensor-core kernel")
        err, tol, row_errs, prev_err = 0.0, 0.0, [], 0.0
        for b in range(len(lens)):
            e = (y[b].float() - y32[b]).abs().max().item()
            t = RAGGED_BF16_RTOL * y32[b].abs().max().item()
            pe = (yprev[b].float() - y32[b]).abs().max().item()
            row_errs.append((e, t))
            if not e <= t or not pe <= t:
                _fail(f"ragged_attention {case} row {b} (live {lens[b]}): max "
                      f"|kernel - plain f32| {e:.3g} (previous kernel {pe:.3g}) "
                      f"> {t:.3g}")
            err, tol, prev_err = max(err, e), max(tol, t), max(prev_err, pe)
        if not torch.isfinite(y).all():
            _fail(f"ragged_attention {case}: non-finite output")
        bound_ms, bound_by = bound(c["nbytes"], c["flops"])
        r = dict(H=n_heads, Hkv=n_kv, hd=hd, route=route,
                 ms=event_ms(run, 20, flush), plain_ms=event_ms(plain, 3, flush),
                 previous_ms=event_ms(previous, 20, flush),
                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                 previous_max_abs_err=prev_err,
                 row_err_and_tolerance=row_errs, bytes=c["nbytes"],
                 pages_visited=c["visited"],
                 table_pages=c["listed"], segments=c["segments"], B=len(lens), C=C)
        k, v, kpos = RA.ragged_gather(c["kp"], c["vp"], c["ppos"], c["pages"])
        G = n_heads // k.shape[2]
        qp = c["qpos"][:, None, :, None]
        mask = ((kpos[:, None, None, :] >= 0) & (kpos[:, None, None, :] <= qp)
                & (qp - kpos[:, None, None, :] < (c["window"] or np.inf)))
        qs = c["q"].transpose(1, 2)
        ks = k.repeat_interleave(G, 2).transpose(1, 2)
        vs = v.repeat_interleave(G, 2).transpose(1, 2)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)
        r["sdpa_dense_ms"] = event_ms(sdpa, 10, flush)
        r["kernel_over_sdpa"] = r["ms"] / r["sdpa_dense_ms"]
        r["previous_over_sdpa"] = r["previous_ms"] / r["sdpa_dense_ms"]
        r["bound_share"] = bound_ms / r["ms"]
        log(f"[{label}] {case} B={len(lens)} C={C} lens={lens}: {json.dumps(r)}")
        log(f"[yardstick] scaled_dot_product_attention on the gathered dense "
            f"view ({case}, {ks.shape[2]} keys per row, not paged, not used "
            f"by the port): {r['sdpa_dense_ms']:.4f} ms")
        records.append(dict(name=f"{label}_{case}", binding="ragged_attention",
                            tolerance=tol, rtol=RAGGED_BF16_RTOL, **r))
    return records


def flash_cases(dev, flush, *, heads=MIXTRAL_HEADS, cases=FLASH_CASES,
                label="flash"):
    """The flash-attention kernel against its plain version, called
    through the binding the model path calls (``ops.flash_attention``) on
    (B, H, S, hd) views of (B, S, H, hd) bf16 tensors, as the prefill
    chunk passes its queries and KV ring; a case may be non-causal over B
    rows (whisper's encoder and cross-attention).  Each (head, row) is
    held against the plain version run in f32 on the same (upcast)
    inputs, within ``FLASH_BF16_RTOL`` of that row's own max |plain|; the
    kernel must take ``wgmma``.  One launch timed alone after an L2 flush;
    ``scaled_dot_product_attention`` (``is_causal`` as the case, no
    window) is timed as a yardstick on the cases a window does not cut;
    the port never calls it.  On the main path's chunk, ``attention_core``
    (what the chunk ran before it took the kernel) is timed too.
    ``heads`` (H, Hkv, hd) and ``cases`` give another model's shapes
    (under ``label``).  Returns the records, one a case."""
    from repro_torch.kernels import flash_attention as FA, ops
    gen = torch.Generator(dev)
    gen.manual_seed(4)
    H, Hkv, hd = heads
    records = []
    for name, Sq, Skv, q_offset, window, *more in cases:
        causal, B = more or (True, 1)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in (rnd(B, Sq, H, hd), rnd(B, Skv, Hkv, hd),
                                               rnd(B, Skv, Hkv, hd)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        run = lambda: ops.flash_attention(q, k, v, **kw)
        plain = lambda: FA.flash_attention_reference(q, k, v, **kw)
        before, wg = ops.flash_attention.launches, FA.launch.routes["wgmma"]
        y = run()
        route = "wgmma" if FA.launch.routes["wgmma"] == wg + 1 else "fma"
        y32 = FA.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        if ops.flash_attention.launches != before + 1:
            _fail(f"flash_attention {name}: the binding did not count its launch")
        if route != "wgmma":
            _fail(f"[{label}] {name}: bfloat16 at head_dim {hd} left the wgmma "
                  f"instance")
        if not torch.isfinite(y).all():
            _fail(f"flash_attention {name}: non-finite output")
        err = (y.float() - y32).abs().amax(-1)
        tol = FLASH_BF16_RTOL * y32.abs().amax(-1)
        if not bool((err <= tol).all()):
            worst = int((err - tol).argmax())
            _fail(f"flash_attention {name}: (head, row) {divmod(worst % (H * Sq), Sq)} max "
                  f"|kernel - plain f32| {err.flatten()[worst]:.3g} > "
                  f"{tol.flatten()[worst]:.3g}")
        nbytes, flops = flash_work(Sq, Skv, q_offset, window, H, Hkv, hd,
                                   causal, B)
        bound_ms, bound_by = bound(nbytes, flops)
        r = dict(H=H, Hkv=Hkv, hd=hd, route=route, B=B, causal=causal, Sq=Sq, Skv=Skv,
                 q_offset=q_offset, window=window, ms=event_ms(run, 10, flush),
                 plain_ms=event_ms(plain, 3, flush),
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                 max_abs_err=float(err.max()),
                 max_err_over_tolerance=float((err / tol).max()))
        r["library_ms"] = None
        if window is None or window >= q_offset + Sq:
            # causal from the top left at q_offset 0, else an explicit mask
            mask = (None if q_offset == 0 or not causal else
                    FA._valid(Sq, Skv, True, window, q_offset, dev))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            r["library_err_over_tolerance"] = float(
                ((sdpa().float() - y32).abs().amax(-1) / tol).max())
            r["library_ms"] = event_ms(sdpa, 10, flush)
        if name == "prefill_chunk":  # what the chunk ran before: the model's plain path
            from repro_torch.models import layers as L
            pos = torch.arange(Skv, dtype=torch.int32, device=dev)
            r["attention_core_ms"] = event_ms(lambda: L.attention_core(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos,
                pos[None], causal=True, window=window), 10, flush)
        r["tflop_s"] = flops / (r["ms"] * 1e-3) / 1e12
        r["bound_share"] = bound_ms / r["ms"]
        r["kernel_over_library"] = (None if r["library_ms"] is None
                                    else r["ms"] / r["library_ms"])
        log(f"[{label}] {name}: {json.dumps(r)}")
        records.append(dict(name=f"{label}_{name}", binding="flash_attention",
                            rtol=FLASH_BF16_RTOL, **r))
    return records


def attention_cases(dev, flush):
    """:func:`ragged_cases` and :func:`flash_cases` at each model of
    :data:`ATTENTION_MODELS`, in order.  Returns the records."""
    records = []
    for suffix, heads, ragged, window, flash in ATTENTION_MODELS:
        records += ragged_cases(dev, flush, heads=heads, cases=ragged,
                                window=window, label=f"ragged{suffix}")
        records += flash_cases(dev, flush, heads=heads, cases=flash,
                               label=f"flash{suffix}")
    return records


def entries(records):
    """The kernels line's entry of each binding with a record: the record
    of its case on the main path (:data:`MAIN_CASES`), with the largest
    errors of every record of the binding."""
    out = {}
    for binding, name in MAIN_CASES.items():
        recs = [r for r in records if r["binding"] == binding]
        main = [r for r in recs if r["name"] == name]
        if not main:
            continue
        e = out[binding] = dict(main[0])
        for k in ("max_abs_err", "max_rel_err", "previous_max_abs_err"):
            if k in e:
                e[k] = max(r[k] for r in recs if k in r)
    return out


def _row(rec):
    """A group (b) record as a ``name,us_per_call,derived`` row."""
    return {"name": rec["name"], "us_per_call": f"{rec['ms'] * 1e3:.2f}",
            "derived": f"bound_share={rec['bound_share']:.3f} "
                       f"({rec['bound_by']})", **rec}


def run(quick=False, device=None):
    """Group (a) on ``device`` (the card unless ``"cpu"``) and, on the
    card, group (b) (the grouped binding at its long case).  Emits the
    rows and returns them."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    rows = reference_rows(dev, quick)
    if dev.type == "cuda":
        flush = new_flush(dev)
        records, tiers = dequant_cases(dev, flush)
        records += attention_cases(dev, flush)
        records += grouped_cases(dev, tiers, flush)[1]
        card = torch.cuda.get_device_name(dev)
        rows += [dict(_row(r), device=card) for r in records]
    common.emit(rows, "kernels")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", "--smoke", action="store_true", dest="quick",
                    help="the reference's reduced shapes for group (a)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
