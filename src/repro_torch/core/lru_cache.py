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
