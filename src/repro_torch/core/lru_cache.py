"""LRU expert cache + speculative staging state machine (paper §3.1/3.3).

The port of the reference's ``core/lru_cache.py``.  Semantics are the
paper's (and the reference's) exactly:

* an expert needed now that is **in the LRU pool** is a *hit* (no copy,
  recency refreshed);
* one **in the staging buffers** is a *speculative hit*: promoted into the
  pool (evicting the least recently used entry), no host transfer;
* otherwise a *demand miss*: one host->device copy, inserted into the pool;
* after a layer is served, the lookahead layer's predictions are staged;
  each one resident nowhere charges one overlappable transfer.

The state is a few small integer arrays per layer and runs on the host
(numpy), where the plans it returns tell ``core/expert_pool`` which copies
to issue.  Tie-breaks follow the reference: the LRU slot is the *first*
minimum of the clock, and the slot of a resident expert the *first*
matching index (``argmin``/``argmax`` semantics).  The slot index into
``cache_ids`` IS the device-pool slot index.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_I32 = np.int32


class LayerCacheState(NamedTuple):
    """State of ONE MoE layer."""

    cache_ids: np.ndarray    # (k,) int32, -1 = empty
    cache_clock: np.ndarray  # (k,) int32 recency stamps
    spec_ids: np.ndarray     # (n_spec,) int32 staged experts, -1 = empty
    clock: int               # monotone counter


class AccessStats(NamedTuple):
    hits: int
    spec_hits: int
    demand_loads: int
    spec_loads: int


def init_layer_state(k: int, n_spec: int) -> LayerCacheState:
    return LayerCacheState(np.full((k,), -1, _I32), np.zeros((k,), _I32),
                           np.full((n_spec,), -1, _I32), 0)


def init_model_state(n_layers: int, k: int, n_spec: int
                     ) -> List[LayerCacheState]:
    return [init_layer_state(k, n_spec) for _ in range(n_layers)]


def layer_slice(state: List[LayerCacheState], l: int) -> LayerCacheState:
    """Layer ``l``'s state of a model state (the reference's slice of its
    stacked leaves)."""
    return state[l]


def set_layer(state: List[LayerCacheState], l: int,
              new: LayerCacheState) -> List[LayerCacheState]:
    """A model state with layer ``l`` replaced by ``new``; ``state`` is
    left as it was (the reference's functional ``.at[l].set``)."""
    out = list(state)
    out[l] = new
    return out


# ----------------------------------------------------------------------
class AccessPlan(NamedTuple):
    """Per-needed-expert decisions of one :func:`access_plan` call:
    ``slots[j]`` serves ``needed[j]`` after the access; ``in_cache`` /
    ``in_spec`` say where its bytes already are (neither = demand load);
    ``spec_slot`` is the staging index when ``in_spec``; ``evicted`` the
    expert displaced by the insertion (-1 on a hit or an empty slot)."""

    slots: np.ndarray      # (K,) int32
    in_cache: np.ndarray   # (K,) bool
    in_spec: np.ndarray    # (K,) bool
    spec_slot: np.ndarray  # (K,) int32
    evicted: np.ndarray    # (K,) int32


def access_plan(state: LayerCacheState, needed: Sequence[int]
                ) -> Tuple[LayerCacheState, AccessStats, AccessPlan]:
    """Serve ``needed`` (K,) expert ids of one layer for one token."""
    ids = state.cache_ids.copy()
    clock_arr = state.cache_clock.copy()
    spec, clk = state.spec_ids, state.clock
    hits = spec_hits = demand = 0
    K = len(needed)
    slots = np.zeros((K,), _I32)
    in_cache_a = np.zeros((K,), bool)
    in_spec_a = np.zeros((K,), bool)
    spec_slot_a = np.zeros((K,), _I32)
    evicted_a = np.zeros((K,), _I32)
    for j in range(K):
        e = int(needed[j])
        match = ids == e
        in_cache = bool(match.any())
        in_spec = (not in_cache) and bool((spec == e).any())
        hits += in_cache
        spec_hits += in_spec
        demand += (not in_cache) and (not in_spec)
        slot = int(np.argmax(match)) if in_cache else int(np.argmin(clock_arr))
        evicted_a[j] = -1 if in_cache else ids[slot]
        clk += 1
        ids[slot] = e
        clock_arr[slot] = clk
        slots[j] = slot
        in_cache_a[j] = in_cache
        in_spec_a[j] = in_spec
        # n_spec = 0: there is no staging tier to point into
        spec_slot_a[j] = int(np.argmax(spec == e)) if spec.shape[0] else 0
    new = LayerCacheState(ids, clock_arr, spec, clk)
    stats = AccessStats(hits, spec_hits, demand, 0)
    plan = AccessPlan(slots, in_cache_a, in_spec_a, spec_slot_a, evicted_a)
    return new, stats, plan


def access(state: LayerCacheState, needed: Sequence[int]
           ) -> Tuple[LayerCacheState, AccessStats]:
    """Serve ``needed`` (K,) expert ids of one layer for one token
    (:func:`access_plan` without its plan)."""
    new, stats, _ = access_plan(state, needed)
    return new, stats


class BatchAccessPlan(NamedTuple):
    """Whole-batch decisions of one :func:`access_plan_batch` call.

    ``slots[t, j]`` is the pool slot serving access (t, j) at access time;
    ``survives[t, j]`` whether that expert still owns the slot after the
    whole batch; ``written[s]`` marks slots some active access inserted
    into.  ``in_cache``/``in_spec``/``spec_slot`` (T, K) are the per-access
    byte sources of :class:`AccessPlan`, which the buffer pool turns into
    copies.
    """

    slots: np.ndarray      # (T, K) int32
    survives: np.ndarray   # (T, K) bool
    written: np.ndarray    # (k,) bool
    in_cache: np.ndarray   # (T, K) bool
    in_spec: np.ndarray    # (T, K) bool
    spec_slot: np.ndarray  # (T, K) int32


def access_plan_batch(state: LayerCacheState, needed: np.ndarray,
                      active: Optional[np.ndarray] = None
                      ) -> Tuple[LayerCacheState, np.ndarray, BatchAccessPlan]:
    """Serve a whole batch ``needed`` (T, K): exactly T sequential
    :func:`access_plan` calls, with inactive rows (``active`` (T,) bool)
    leaving state and counters untouched.  Returns ``(new_state, delta,
    plan)``; ``delta`` is the (4,) int32 [hits, spec_hits, demand, 0]
    counter delta over the active rows."""
    needed = np.asarray(needed)
    T, K = needed.shape
    k = state.cache_ids.shape[0]
    lru = state
    delta = np.zeros((4,), _I32)
    written = np.zeros((k,), bool)
    per_t = []
    for t in range(T):
        act = True if active is None else bool(active[t])
        new_lru, stats, plan = access_plan(lru, needed[t])
        per_t.append(plan)
        if not act:
            continue
        delta += np.asarray([stats.hits, stats.spec_hits, stats.demand_loads,
                             0], _I32)
        written[plan.slots[~plan.in_cache]] = True
        lru = new_lru
    stack = lambda f: np.stack([getattr(p, f) for p in per_t])
    slots = stack("slots")
    survives = lru.cache_ids[slots] == needed
    return lru, delta, BatchAccessPlan(slots, survives, written,
                                       stack("in_cache"), stack("in_spec"),
                                       stack("spec_slot"))


class StagePlan(NamedTuple):
    """Per-prediction sourcing of one :func:`stage_plan` call: ``loads[j]``
    charges one host->device transfer; otherwise staging buffer j is
    filled from pool slot ``cache_slot[j]`` (``in_cache``) or the previous
    staging buffer ``old_spec_slot[j]`` (``in_old_spec``), or duplicates an
    earlier prediction of the same call."""

    loads: np.ndarray          # (n_spec,) bool
    in_cache: np.ndarray       # (n_spec,) bool
    cache_slot: np.ndarray     # (n_spec,) int32
    in_old_spec: np.ndarray    # (n_spec,) bool
    old_spec_slot: np.ndarray  # (n_spec,) int32


def stage_plan(state: LayerCacheState, predicted: Sequence[int]
               ) -> Tuple[LayerCacheState, StagePlan, int]:
    """Stage ``predicted`` (n_spec,) experts into this layer's buffers;
    returns the new state, the copy plan and the transfer count."""
    ids, clock_arr, old_spec, clk = state
    predicted = np.asarray(predicted, _I32)
    n = predicted.shape[0]
    loads = np.zeros((n,), bool)
    in_cache_a = np.zeros((n,), bool)
    cache_slot = np.zeros((n,), _I32)
    in_old_a = np.zeros((n,), bool)
    old_slot = np.zeros((n,), _I32)
    for j in range(n):
        e = int(predicted[j])
        in_cache = bool((ids == e).any())
        in_old = bool((old_spec == e).any())
        resident = in_cache or in_old or bool((predicted[:j] == e).any())
        loads[j] = e >= 0 and not resident
        in_cache_a[j] = in_cache
        cache_slot[j] = int(np.argmax(ids == e))
        in_old_a[j] = (not in_cache) and in_old
        old_slot[j] = int(np.argmax(old_spec == e)) if old_spec.shape[0] else 0
    new = LayerCacheState(ids, clock_arr, predicted.copy(), clk)
    plan = StagePlan(loads, in_cache_a, cache_slot, in_old_a, old_slot)
    return new, plan, int(loads.sum())


def stage_speculative(state: LayerCacheState, predicted: Sequence[int]
                      ) -> Tuple[LayerCacheState, int]:
    """Stage ``predicted`` (n_spec,) experts into this layer's buffers;
    returns (new state, transfers): only predictions resident nowhere
    (pool or previous staging) are charged (:func:`stage_plan` without
    its plan)."""
    new, _, transfers = stage_plan(state, predicted)
    return new, transfers


# ----------------------------------------------------------------------
class PyLRU:
    """Plain-python oracle with the same semantics as :func:`access_plan`
    / :func:`stage_plan`, down to the eviction sequence."""

    def __init__(self, k: int, n_spec: int):
        self.k = k
        self.cache: List[int] = []   # most-recent-last
        self.spec: List[int] = []
        self.hits = self.spec_hits = self.demand = self.spec_loads = 0
        self.evictions: List[int] = []  # expert ids displaced, in order

    def access(self, needed: Sequence[int]):
        for e in needed:
            e = int(e)
            if e in self.cache:
                self.hits += 1
                self.cache.remove(e)
                self.cache.append(e)
            else:
                if e in self.spec:
                    self.spec_hits += 1
                else:
                    self.demand += 1
                if self.k > 0:  # k=0 = caching disabled (ablation)
                    while len(self.cache) >= self.k:
                        self.evictions.append(self.cache.pop(0))
                    self.cache.append(e)

    def stage(self, predicted: Sequence[int]):
        fresh = []
        seen = set()
        for e in predicted:
            e = int(e)
            if e >= 0 and e not in self.cache and e not in self.spec \
                    and e not in seen:
                self.spec_loads += 1
            seen.add(e)
            fresh.append(e)
        self.spec = [e for e in fresh if e >= 0]


# ----------------------------------------------------------------------
# Beyond-paper cache policies and the trace replays of the paper's Fig. 2
# (the paper: "LRU is a very simple strategy that does not consider
# factors like expert activation frequencies ...")
class PyLFUDecay:
    """Frequency cache with exponential decay (half-life in accesses)."""

    def __init__(self, k: int, decay: float = 0.95):
        self.k = k
        self.decay = decay
        self.score: dict = {}
        self.cache: set = set()
        self.hits = self.demand = 0

    def access(self, needed: Sequence[int]):
        for key in list(self.score):
            self.score[key] *= self.decay
        for e in needed:
            e = int(e)
            self.score[e] = self.score.get(e, 0.0) + 1.0
            if e in self.cache:
                self.hits += 1
            else:
                self.demand += 1
                self.cache.add(e)
                if len(self.cache) > self.k:
                    victim = min(self.cache, key=lambda x: self.score.get(x, 0))
                    self.cache.discard(victim)


def belady_hit_ratio(layer_trace: np.ndarray, k: int) -> float:
    """Clairvoyant (Belady/MIN) eviction upper bound for one layer's
    access sequence.  layer_trace: (n_tokens, top_k) expert ids."""
    seq = [int(e) for row in layer_trace for e in row]
    n = len(seq)
    nxt_use = [float("inf")] * n
    last: dict = {}
    for i in range(n - 1, -1, -1):
        nxt_use[i] = last.get(seq[i], float("inf"))
        last[seq[i]] = i
    cache: dict = {}  # expert -> next use index
    hits = 0
    for i, e in enumerate(seq):
        if e in cache:
            hits += 1
            cache[e] = nxt_use[i]
            continue
        if len(cache) >= k:
            # true MIN: bypass the incoming expert if its own next use is
            # the farthest
            victim = max(cache, key=lambda x: cache[x])
            if cache[victim] <= nxt_use[i]:
                continue
            del cache[victim]
        cache[e] = nxt_use[i]
    return hits / max(1, n)


def policy_comparison(trace: np.ndarray, cache_sizes: Sequence[int]) -> dict:
    """Hit ratios per (policy, k): LRU (the paper's), LFU with decay and
    Belady, over a (n_tokens, n_layers, top_k) trace."""
    n_tokens, n_layers, top_k = trace.shape
    out = {}
    for k in cache_sizes:
        lru = [PyLRU(k, 0) for _ in range(n_layers)]
        lfu = [PyLFUDecay(k) for _ in range(n_layers)]
        for t in range(n_tokens):
            for l in range(n_layers):
                lru[l].access(trace[t, l])
                lfu[l].access(trace[t, l])
        tot = n_tokens * n_layers * top_k
        out[("lru", k)] = sum(c.hits for c in lru) / tot
        out[("lfu_decay", k)] = sum(c.hits for c in lfu) / tot
        out[("belady", k)] = float(np.mean(
            [belady_hit_ratio(trace[:, l], k) for l in range(n_layers)]))
    return out


def lru_hit_curve(trace: np.ndarray, cache_sizes: Sequence[int]) -> dict:
    """The paper's Fig. 2 (left): an expert-activation trace (n_tokens,
    n_layers, top_k) replayed through an LRU cache of each size k; the
    hit ratio per k."""
    n_tokens, n_layers, top_k = trace.shape
    out = {}
    for k in cache_sizes:
        caches = [PyLRU(k, 0) for _ in range(n_layers)]
        for t in range(n_tokens):
            for l in range(n_layers):
                caches[l].access(trace[t, l])
        out[k] = sum(c.hits for c in caches) / (n_tokens * n_layers * top_k)
    return out
