"""The yardstick's arithmetic: the card's peaks, and the bytes and
operations a kernel call or a model token needs, from shapes alone.

``record_bytes``, ``dequant_work``, ``grouped_work``, ``flash_work`` and
``bound`` are frozen copies of the port's ``benchmarks/kernels_bench.py``
as this benchmark was written; ``ragged_work`` counts the same pages and
pairs from a step's host positions instead of the program's work list.
Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import hqq as RH

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# Mixtral's expert matrices (gate, down, up) and the dequant bindings'
# cases whose bounds the port's PERF.md tabulates
SHAPES = ((4096, 14336), (14336, 4096), (4096, 14336))
DEQUANT_CASES = {"dequant_matmul_slots": dict(B=2, M=1, S=4),
                 "dequant_matmul_batched": dict(B=8, M=16, S=8),
                 "dequant_matmul": dict(B=1, M=1, S=1)}


def record_bytes(K, N, bits, group_size=None) -> int:
    """Stored bytes of one (K, N) weight in the HQQ layout with the
    scheme's meta groups: packed codes, 8-bit scale and zero, four f16
    meta leaves."""
    scheme = RH.SCHEMES[bits]
    gs = group_size or scheme["group_size"]
    G = K // gs
    sg = RH.meta_group(G, scheme["scale_group"])
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
    matrices of a MoE layer."""
    c = DEQUANT_CASES[name]
    work = [dequant_work(c["B"] * c["M"], K, N, bits, c["B"]) for K, N in SHAPES]
    return tuple(map(sum, zip(*work)))


def grouped_work(counts, bits=2, shapes=SHAPES):
    """(bytes, operations) of the grouped binding over len(counts) records
    with ``counts`` rows each, for the three matrices."""
    rows = int(sum(counts))
    work = [dequant_work(rows, K, N, bits, len(counts)) for K, N in shapes]
    return tuple(map(sum, zip(*work)))


def flash_work(Sq, Skv, q_offset, window, H, Hkv, hd, causal=True, B=1,
               elem=2):
    """(bytes, operations) over B rows: q and out once, the K/V rows some
    query can see once; 2 x 2 x hd operations per valid (query head,
    query, key)."""
    qpos = q_offset + np.arange(Sq)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(0, qpos - window + 1)
    hi = np.minimum(Skv, qpos + 1) if causal else np.full(Sq, Skv)
    pairs = int(np.maximum(hi - lo, 0).sum())
    keys = int(hi.max() - lo.min())
    nbytes = 2 * H * Sq * hd * elem + 2 * Hkv * keys * hd * elem
    return B * nbytes, B * 4 * hd * H * pairs


def visible_pairs(pos, C, window=None) -> int:
    """(query, key) pairs of C queries at positions pos .. pos + C - 1
    over keys 0 .. the query's position, within ``window``."""
    q = pos + np.arange(C) + 1
    return int(np.minimum(q, window).sum() if window else q.sum())


def ragged_work(pos, C, heads, window, page_size, elem=2):
    """(bytes, operations) of one paged attention call over rows whose
    queries sit at ``pos[b] .. pos[b] + C - 1``: each page holding a
    position some query sees read once (k, v and the page's positions),
    q and out once; 2 x 2 x hd operations per valid (query head, query,
    key)."""
    H, Hkv, hd = heads
    pages = pairs = 0
    for p in np.asarray(pos, np.int64).reshape(-1):
        hi = p + C - 1
        lo = 0 if window is None else max(0, p - window + 1)
        pages += hi // page_size - lo // page_size + 1
        pairs += visible_pairs(p, C, window)
    rows = len(np.asarray(pos).reshape(-1))
    nbytes = (pages * (2 * page_size * Hkv * hd * elem + page_size * 4)
              + 2 * rows * C * H * hd * elem)
    return nbytes, 4 * H * hd * pairs


def bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over ``flop_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def token_matmul_flops(cfg: dict) -> int:
    """Model operations of one token outside attention's scores: the
    attention projections, the router, the top-k experts' three matrices
    in every layer, and the head over the real vocabulary."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    per_layer = 2 * D * (H + 2 * Hkv) * hd + 2 * H * hd * D + 2 * D * E + k * 3 * 2 * D * F
    return cfg["num_hidden_layers"] * per_layer + 2 * D * cfg["vocab_size"]


def attention_score_flops(cfg: dict, pairs: int) -> int:
    """q.k and p.v over ``pairs`` (query, key) pairs in every layer."""
    return (cfg["num_hidden_layers"] * 4 * cfg["num_attention_heads"]
            * cfg["head_dim"] * pairs)
