"""Analytic offloading cost model -> tokens/s (port of the reference's
``core/cost_model.py``; the paper's Table 2).

    t_token = t_sw + t_compute + t_demand + t_spec_spill

* ``t_compute``: batch-1 decode reads the active parameters once per
  token, ``active_bytes / (mem_bw * mem_eff)``, plus a per-layer
  overhead (launches, dequantization, routing).
* ``t_demand``: blocking host->device copies of cache misses,
  ``n_miss * (expert_bytes / link_rate + copy_latency)``.
* ``t_spec_spill``: speculative copies overlap the next layer's compute;
  only the part that exceeds a layer's compute window blocks.
* naive offloading streams whole MoE layers, overlapped with compute.

The cache statistics come from measured routing (a trace replay,
:func:`replay_policies`, or an engine's counters); the constants of the
one hardware row are measured on the card (``HARDWARE``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, parse_block
from repro_torch.core.lru_cache import PyLRU

# bits/param including group scale/zero + meta-quant overhead (what
# quant/hqq.bits_per_param gives on the paper's group-size schemes)
EFFECTIVE_BITS = {16: 16.0, 8: 8.5, 4: 4.5, 3: 3.5, 2: 3.25}


@dataclass(frozen=True)
class Hardware:
    name: str
    pcie_gbps: float         # effective host->device GB/s
    mem_bw_gbps: float       # device memory bandwidth GB/s
    mem_eff: float           # achievable fraction for the decode GEMV
    copy_latency_s: float    # per host->device copy fixed cost
    layer_overhead_s: float  # per-layer launch/dequant overhead
    vram_gb: float
    # per-token software overhead of the interactive loop (Python,
    # launches, sampling): fitted once, then held fixed
    sw_overhead_s: float = 0.21


# One row: the card this port runs on.  Every field is a measurement of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit
# (one run, recorded in PERF.md with the runs that followed):
# pcie_gbps is [main]'s h2d_probe_gb_s (one 64 MB expert record, pinned
# host -> device: 49.96 GB/s); mem_bw_gbps the data sheet's 3.35 TB/s
# (chip_smoke.HBM_BYTES_PER_S); mem_eff the slot binding's bound share
# at [main]'s decode shapes ([kernel]: 0.0400 / 0.1211 ms);
# copy_latency_s the median of a 4 KiB pinned copy ([main]
# copy_latency_probe_s: 23.4 us).  The two overheads were fitted once
# ([paper], fit_overheads) to [main]'s pipelined decode (median 33.13
# tok/s of three runs; kernels busy 2.78 ms per token) and are held
# fixed: layer_overhead_s is the kernel time per layer beyond the read
# of the active bytes, sw_overhead_s the rest of the token.
HARDWARE = {
    "h100": Hardware("NVIDIA H100 80GB HBM3", pcie_gbps=49.96,
                     mem_bw_gbps=3350.0, mem_eff=0.3300,
                     copy_latency_s=2.338e-5, layer_overhead_s=1.882e-4,
                     vram_gb=80.0, sw_overhead_s=0.02159),
}


# ----------------------------------------------------------------------
def expert_param_count(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff  # swiglu experts (gate/up/down)


def expert_bytes(cfg: ModelConfig, bits: int) -> float:
    return expert_param_count(cfg) * EFFECTIVE_BITS[bits] / 8.0


def active_param_bytes(cfg: ModelConfig, expert_bits: int,
                       attn_bits: int) -> float:
    """Bytes read from device memory per generated token: the top-k
    experts of every MoE layer at ``expert_bits``; attention, dense MLPs
    and the embedding at ``attn_bits``."""
    moe_layers = cfg.moe_layer_count
    n_expert_active = (moe_layers * cfg.moe.top_k * expert_param_count(cfg)
                       if cfg.moe is not None else 0)
    attn_per_layer = cfg.d_model * cfg.head_dim * (cfg.n_heads * 2
                                                   + cfg.n_kv_heads * 2)
    mlp_layers = sum(1 for k in cfg.layer_kinds()
                     if parse_block(k)[1] == "mlp")
    mats = 2 if cfg.mlp_act == "gelu" else 3  # gated acts add a matrix
    dense = (cfg.n_layers * attn_per_layer
             + mlp_layers * mats * cfg.d_model * cfg.d_ff
             + cfg.vocab_size * cfg.d_model)
    return (n_expert_active * EFFECTIVE_BITS[expert_bits] / 8.0
            + dense * EFFECTIVE_BITS[attn_bits] / 8.0)


def recurrent_state_bytes(cfg: ModelConfig) -> int:
    """Recurrent decode state of one sequence.  The port runs attention
    blocks only (``transformer.BLOCK_KINDS``), which keep no recurrent
    state, so this is 0; the reference's RG-LRU/mLSTM/sLSTM terms come
    with those mixers (ROADMAP queue 1, item 6)."""
    return 0


def kv_read_bytes_per_token(cfg: ModelConfig, context_len: float,
                            kv_bits: int = 16) -> float:
    """Device bytes of KV cache that one decode token reads at a live
    context of ``context_len``: every K and V entry of every attention
    layer, sliding-window layers capped at the window."""
    per_pos = 2 * cfg.n_kv_heads * cfg.head_dim * kv_bits / 8.0  # K and V
    total = 0.0
    for kind in cfg.layer_kinds():
        mixer = parse_block(kind)[0]
        if mixer == "attn":
            span = context_len
        elif mixer == "swa":
            span = min(context_len, cfg.sliding_window or context_len)
        else:
            continue
        total += span * per_pos
    return total


@dataclass
class TokenStats:
    """Per-token averages measured from a routing trace replay."""

    demand_loads: float   # blocking expert copies / token (total over layers)
    spec_loads: float     # speculative copies / token
    hits: float
    spec_hits: float


def tokens_per_second(cfg: ModelConfig, hw: Hardware, stats: TokenStats,
                      expert_bits: int, attn_bits: int = 4,
                      naive: bool = False, context_len: float = 0.0,
                      kv_bits: int = 16) -> float:
    """Modelled batch-1 decode tokens/s.  ``context_len`` adds the KV
    reads of decode attention at that live context to the memory-bound
    term (0: weights only, the Table-2 setting)."""
    eb = expert_bytes(cfg, expert_bits) if cfg.moe is not None else 0.0
    moe_layers = cfg.moe_layer_count
    t_compute = ((active_param_bytes(cfg, expert_bits, attn_bits)
                  + kv_read_bytes_per_token(cfg, context_len, kv_bits)
                  + 2 * recurrent_state_bytes(cfg))  # read + write
                 / (hw.mem_bw_gbps * 1e9 * hw.mem_eff)
                 + cfg.n_layers * hw.layer_overhead_s)
    if naive:
        if cfg.moe is None:
            raise ValueError("naive offloading models per-layer expert "
                             "streaming; there are no experts to stream "
                             f"in dense arch {cfg.name}")
        total_bytes = moe_layers * cfg.moe.num_experts * eb
        t_transfer = total_bytes / (hw.pcie_gbps * 1e9) \
            + moe_layers * hw.copy_latency_s
        return 1.0 / (hw.sw_overhead_s
                      + max(t_transfer, t_compute) + 0.1 * t_compute)

    t_demand = stats.demand_loads * (eb / (hw.pcie_gbps * 1e9)
                                     + hw.copy_latency_s)
    # speculative copies overlap with one layer's compute window each
    per_layer_window = t_compute / max(cfg.n_layers, 1)
    t_spec_each = eb / (hw.pcie_gbps * 1e9) + hw.copy_latency_s
    spill_each = max(0.0, t_spec_each - per_layer_window)
    t_spec_spill = stats.spec_loads * spill_each * 0.5  # partial overlap
    return 1.0 / (hw.sw_overhead_s + t_compute + t_demand + t_spec_spill)


def fit_overheads(cfg: ModelConfig, hw: Hardware, stats: TokenStats,
                  expert_bits: int, attn_bits: int, tok_s: float,
                  kernel_s_per_token: float) -> Hardware:
    """``hw`` with its two overheads fitted to one measured cell: a
    decode at ``tok_s`` with these per-token ``stats``, whose kernels
    took ``kernel_s_per_token`` of device time per token.
    ``layer_overhead_s`` is the kernel time beyond the memory-bound read
    of the active bytes, per layer; ``sw_overhead_s`` is what then
    remains of the token's time under :func:`tokens_per_second`."""
    t_bytes = (active_param_bytes(cfg, expert_bits, attn_bits)
               / (hw.mem_bw_gbps * 1e9 * hw.mem_eff))
    layer = max(0.0, kernel_s_per_token - t_bytes) / cfg.n_layers
    fitted = dataclasses.replace(hw, layer_overhead_s=layer,
                                 sw_overhead_s=0.0)
    rest = 1.0 / tok_s - 1.0 / tokens_per_second(cfg, fitted, stats,
                                                 expert_bits, attn_bits)
    return dataclasses.replace(fitted, sw_overhead_s=max(0.0, rest))


# ----------------------------------------------------------------------
def replay_policies(trace_ids, hiddens=None, routers=None, k: int = 4,
                    n_spec: int = 2, lookahead: int = 1) -> Dict[str, TokenStats]:
    """Replay a routing trace through the paper's policy ablations.

    trace_ids: (n_tokens, n_layers, top_k) numpy int array.
    hiddens/routers enable the speculative policy (Fig-2-right machinery).
    Returns per-policy TokenStats (averages per token).
    """
    n_tokens, n_layers, top_k = trace_ids.shape
    out = {}

    preds = None
    if hiddens is not None and routers is not None:
        logits = np.einsum("tld,lde->tle", hiddens[:, : n_layers - lookahead],
                           routers[lookahead:])
        order = np.argsort(-logits, axis=-1)
        preds = order[..., :n_spec]  # (T, L-lookahead, n_spec)

    def run(policy_k, use_spec):
        caches = [PyLRU(policy_k, n_spec) for _ in range(n_layers)]
        for t in range(n_tokens):
            for l in range(n_layers):
                caches[l].access(trace_ids[t, l])
                if use_spec and preds is not None and l + lookahead < n_layers:
                    caches[l + lookahead].stage(preds[t, l])
        tot = lambda f: sum(getattr(c, f) for c in caches) / n_tokens
        return TokenStats(demand_loads=tot("demand"), spec_loads=tot("spec_loads"),
                          hits=tot("hits"), spec_hits=tot("spec_hits"))

    out["full"] = run(k, True)
    out["no_spec"] = run(k, False)
    out["no_lru_no_spec"] = run(0, False)
    # naive handled analytically in tokens_per_second(naive=True)
    out["naive"] = TokenStats(0, 0, 0, 0)
    return out
