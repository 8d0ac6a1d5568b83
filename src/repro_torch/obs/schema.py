"""The telemetry plane's namespaced metrics schema (the port's own copy of
the reference's ``obs/schema.py``; the key sets are the reference's, so a
file the port writes passes ``tools/check_metrics_schema.py``, which
checks against the reference's copy).

Metric names are ``namespace.key``.  Namespaces:

* ``engine``   — step/token/request lifecycle counts (collector-backed).
* ``kv``       — KV occupancy, from the slot/page manager (collector).
* ``offload``  — expert-streaming traffic counters (collector; only on
  offloaded engines — the counters the engine already fetches).
* ``jit``      — process-wide executable cache.  The port has no XLA
  executable cache; its counterpart is the CUDA kernel-library cache of
  ``kernels/build.py`` (``obs.jit_cache_metrics``).
* ``step``     — per-engine-step phase breakdown (declared counters +
  wall-clock histogram; only when timing is enabled).
* ``exec``     — executor dispatch phases, per plane (declared when an
  observer is attached; the packed planes split mixer/MoE/staging).
* ``request``  — per-request lifecycle aggregates (declared with timing).
* ``roofline`` — measured-vs-predicted accounting (gauges; set when a
  roofline accountant is attached).
* ``spec``     — token-level draft-and-verify accounting (declared only
  when speculation is wired: per-round proposed/accepted histograms,
  cumulative acceptance rate, h2d bytes per accepted token —
  DESIGN.md §11).
* ``prefix``   — radix prefix-cache accounting (collector; only when the
  engine has a ``prefix_cache_pages`` budget): lookup/hit counters and
  the index's node/page population (DESIGN.md §13).
* ``kv_host``  — KV host-swap / preemption accounting (collector; only
  when preemption is on): host pool occupancy, swap traffic bytes and
  the preempt/resume/recompute lifecycle counts (DESIGN.md §13).
* ``faults``   — fault-injection + terminal-status accounting
  (collector; always present on ContinuousEngine so chaos and clean
  runs share one schema — all fire counts are zero without an
  injector; DESIGN.md §14).

The legacy flat ``ContinuousEngine.stats()`` dict is a *projection* of
this schema (``repro_torch.obs.flatten_legacy``): ``engine.*`` keys flatten
bare, ``kv.*`` → ``kv_*``, ``offload.*`` → ``offload_*`` and every other
namespace → ``<ns>_<key>`` — collisions are structurally impossible
because namespaces flatten through disjoint prefixes (asserted).
"""
from __future__ import annotations

from typing import Dict, FrozenSet

SCHEMA_VERSION = 1

ENGINE_KEYS = frozenset({
    "steps", "joins", "evictions", "finished", "waiting", "running",
    "tokens", "tokens_per_step", "decode_tokens", "queue_rejected",
})

KV_KEYS_DENSE = frozenset({
    "layout", "slots_in_use", "slots_free", "positions_reserved",
    "peak_positions_reserved", "positions_live", "slot_lengths",
})

KV_KEYS_PAGED = frozenset({
    "layout", "slots_in_use", "slots_free", "peak_positions_reserved",
    "positions_live", "slot_lengths", "slot_pages", "pages_total",
    "pages_free", "pages_in_use", "pages_peak_in_use",
    "pages_peak_committed", "pages_reserved_unallocated", "page_size",
})

OFFLOAD_KEYS = frozenset({
    "hits", "spec_hits", "demand_loads", "spec_loads", "bytes_h2d",
    "bytes_per_token",
})

JIT_KEYS = frozenset({"builds", "hits", "entries"})

# per-step phase breakdown: plan build / prefill chunks / decode dispatch
# / kernel wait (the device sync) / host-side sampling / bookkeeping
STEP_KEYS = frozenset({
    "timed", "plan_ns", "chunk_ns", "dispatch_ns", "sync_ns",
    "sample_ns", "host_ns", "wall_ms",
})

# executor dispatch phases differ by plane — the packed_pipelined plane
# is the only one with a separate speculative-staging dispatch
EXEC_KEYS_BY_PLANE: Dict[str, FrozenSet[str]] = {
    "plain": frozenset({"dispatch_ns"}),
    "packed_vectorized": frozenset({"embed_ns", "block_ns", "head_ns"}),
    "packed_pipelined": frozenset({"embed_ns", "mixer_ns", "moe_ns",
                                   "stage_ns", "head_ns"}),
}

REQUEST_KEYS = frozenset({
    "submitted", "finished", "queue_wait_steps", "gen_tokens",
})

ROOFLINE_KEYS = frozenset({
    "hw", "windows", "window_steps", "measured_tok_s", "predicted_tok_s",
    "delta_ratio", "measured_h2d_bytes_per_token",
    "naive_h2d_bytes_per_token", "h2d_savings_ratio", "context_len",
    # per-layer-kind state-plane traffic (DESIGN.md §12): fixed-size
    # recurrent carries (read+write, flat in context) and the shared
    # encoder-KV cross-read — both set at attach time per config
    "rec_state_bytes_per_token", "enc_kv_read_bytes_per_token",
    # prefix-reuse + preemption traffic (DESIGN.md §13): cumulative KV
    # swap bytes normalized by decode tokens, and the cumulative prompt
    # tokens whose prefill a prefix hit skipped
    "kv_swap_bytes_per_token", "prefix_hit_tokens",
})

SPEC_KEYS = frozenset({
    "rounds", "proposed", "accepted", "acceptance_rate",
    "bytes_h2d_per_accepted",
})

# prefix-cache accounting (DESIGN.md §13): engine-side hit counters
# (bumped only on successful admission — lookups retry while stalled)
# plus the index's own population/eviction counters
PREFIX_KEYS = frozenset({
    "lookups", "hit_tokens", "prefills_skipped", "nodes", "cached_pages",
    "inserted_pages", "evicted_pages",
})

# host-swap / preemption accounting (DESIGN.md §13): the HostPagePool's
# budget + traffic counters plus the engine/scheduler lifecycle counts
KV_HOST_KEYS = frozenset({
    "pages_total", "pages_in_use", "peak_pages_in_use", "swap_out_bytes",
    "swap_in_bytes", "preemptions", "resumes", "recomputes", "swapped_now",
})

# fault-injection + request-lifecycle accounting (DESIGN.md §14): the
# injector's per-site fire counts (all zero on a fault-free engine — the
# namespace is always present so chaos and clean runs share one schema),
# the executor's fetch retry/degrade ladder, NaN quarantines, and the
# terminal-status census over every request the engine has ever seen
FAULTS_KEYS = frozenset({
    "enabled", "injected", "fired_expert_fetch", "fired_swap_out",
    "fired_swap_in", "fired_page_pool", "fired_nan_logits",
    "fired_slow_step", "fetch_retries", "fetch_degraded",
    "nan_quarantined", "completed", "cancelled", "deadline_exceeded",
    "rejected", "failed",
})

HISTOGRAM_FIELDS = frozenset({"count", "sum", "min", "max", "p50", "p95",
                              "buckets"})


def expected_namespaces(*, kv_layout: str = "dense", offloaded: bool = False,
                        timing: bool = True, plane: str = "plain",
                        roofline: bool = True, speculative: bool = False,
                        prefix_cache: bool = False, kv_host: bool = False,
                        faults: bool = True
                        ) -> Dict[str, FrozenSet[str]]:
    """The exact ``{namespace: key set}`` a ContinuousEngine snapshot
    carries for one engine/plane/KV-layout combination — what the
    snapshot tests and the CI validator both check against."""
    out = {
        "engine": ENGINE_KEYS,
        "kv": KV_KEYS_PAGED if kv_layout == "paged" else KV_KEYS_DENSE,
        "jit": JIT_KEYS,
    }
    if offloaded:
        out["offload"] = OFFLOAD_KEYS
    if speculative:
        out["spec"] = SPEC_KEYS
    if prefix_cache:
        out["prefix"] = PREFIX_KEYS
    if kv_host:
        out["kv_host"] = KV_HOST_KEYS
    if faults:
        out["faults"] = FAULTS_KEYS
    if timing:
        out["step"] = STEP_KEYS
        out["request"] = REQUEST_KEYS
        out["exec"] = EXEC_KEYS_BY_PLANE[plane]
        if roofline:
            out["roofline"] = ROOFLINE_KEYS
    return out
