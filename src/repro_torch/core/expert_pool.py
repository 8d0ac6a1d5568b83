"""Packed expert weights: pinned host store + per-layer device buffer pool.

The data plane of the offloading system, ported from the reference's
``core/expert_pool.py``.  Expert weights are HQQ-quantized once and then
stay packed.  Every residency tier is a :class:`Tier`: one uint8 buffer
``(L_moe, S, R)`` holding, per (layer, slot), ONE contiguous record of
``R`` bytes with all three matrices' packed, scale, zero and meta leaves.
So a demand load or a prefetch is one ``cudaMemcpyAsync`` of
:func:`per_expert_nbytes` bytes, the paper's pinned-buffer design.

* **host store** ``(L_moe, E)``, pinned host memory when the pool is on
  the card;
* **LRU pool** ``(L_moe, cache_size)`` and **staging** ``(L_moe,
  num_speculative)`` on the device; the pool carries T*K - 1 **overflow**
  records after it, for the accesses of a T-row batch that lose their
  slot to a later access of the same batch.

The QTensors the kernel reads are views into a tier's buffer
(:attr:`Tier.experts`), so the pool is read in place, by slot.

:func:`acquire` and :func:`stage` run the host-side state machine
(``core/lru_cache``) and issue copies only where its plans say so: h2d for
demand misses and ``StagePlan.loads``; d2d for speculative hits (staging
-> pool slot) and the resident sources of a stage plan.  Demand copies go
on the compute stream; on the pipelined plane staging copies go on a side
copy stream, fenced by a CUDA event the compute stream waits on at that
layer's next :func:`acquire`, and on the others on the compute stream.
Every h2d byte issued is counted in ``PoolState.h2d_bytes``.

``vectorized=False`` selects the reference's sequential data plane, the
baseline of its offload benchmark (``pr2_sync``): one row at a time, one
copy per access into a **serve** tier of T*K records (and per staging
buffer), the same counters, LRU state and h2d bytes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, OffloadSpec, parse_block
from repro_torch.core import lru_cache as LC
from repro_torch.quant import hqq

EXPERT_MATS = ("w_gate", "w_up", "w_down")

# the fault site of the h2d fetch ``acquire`` performs: the executor asks
# the fault plane at this boundary, before a layer's acquire, and on a
# fault that its retries do not clear runs the layer store-direct
# (``models/moe.moe_apply_packed_stream``) without touching the pool
FAULT_SITE = "expert_fetch"


class PackedExperts(NamedTuple):
    """Three stacked packed QTensors (views into a :class:`Tier`)."""

    w_gate: hqq.QTensor
    w_up: hqq.QTensor
    w_down: hqq.QTensor

    def slice(self, *idx) -> "PackedExperts":
        return PackedExperts(*(hqq.slice_leading(qt, idx) for qt in self))

    def head(self, n: int) -> "PackedExperts":
        """The first ``n`` slots of an (S, ...) stack, as views."""
        def cut(qt):
            meta = (None if qt.meta is None
                    else {k: v[:n] for k, v in qt.meta.items()})
            return hqq.QTensor(qt.packed[:n], qt.scale[:n], qt.zero[:n], meta,
                               qt.bits, qt.group_size, (n,) + qt.shape[1:])
        return PackedExperts(*(cut(qt) for qt in self))


@dataclasses.dataclass(frozen=True)
class Leaf:
    mat: str
    name: str          # packed | scale | zero | s_scale | s_min | z_scale | z_min
    offset: int        # bytes into the record
    shape: Tuple[int, ...]  # per (layer, slot)
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class RecordLayout:
    """Where each leaf of one expert sits inside its record."""

    leaves: Tuple[Leaf, ...]
    bits: int
    group_size: int
    mat_shapes: Tuple[Tuple[int, int], ...]  # (K, N) per EXPERT_MATS

    @property
    def record_bytes(self) -> int:
        last = self.leaves[-1]
        return last.offset + last.nbytes

    @classmethod
    def of(cls, qts: Dict[str, hqq.QTensor], n_lead: int) -> "RecordLayout":
        """Layout of the per-expert leaves of ``qts`` (one QTensor per
        matrix, ``n_lead`` leading stack axes), in storage order."""
        leaves, off = [], 0
        q0 = qts[EXPERT_MATS[0]]
        for mat in EXPERT_MATS:
            for name, a in hqq.leaves(qts[mat]):
                if off % _itemsize(a.dtype):
                    raise ValueError(f"{mat}.{name} would start at byte {off}, "
                                     f"misaligned for {a.dtype}")
                leaf = Leaf(mat, name, off, tuple(a.shape[n_lead:]), a.dtype)
                leaves.append(leaf)
                off += leaf.nbytes
        if off % 4:
            raise ValueError(f"expert record of {off} bytes is not a "
                             f"multiple of 4")
        return cls(tuple(leaves), q0.bits, q0.group_size,
                   tuple(tuple(qts[m].shape[-2:]) for m in EXPERT_MATS))

    def views(self, buf: torch.Tensor) -> PackedExperts:
        """QTensor views of every record of ``buf`` (L, S, R)."""
        L, S, R = buf.shape
        assert R == self.record_bytes, (R, self.record_bytes)
        per_mat: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in EXPERT_MATS}
        for lf in self.leaves:
            size = _itemsize(lf.dtype)
            flat = buf if size == 1 else buf.view(lf.dtype)
            lo = lf.offset // size
            n = math.prod(lf.shape)
            per_mat[lf.mat][lf.name] = flat[:, :, lo: lo + n].view(
                (L, S) + lf.shape)
        out = []
        for mat, (K, N) in zip(EXPERT_MATS, self.mat_shapes):
            d = per_mat[mat]
            meta = ({k: d[k] for k in hqq.META_KEYS}
                    if "s_scale" in d else None)
            out.append(hqq.QTensor(d["packed"], d["scale"], d["zero"], meta,
                                   self.bits, self.group_size, (L, S, K, N)))
        return PackedExperts(*out)


class Tier:
    """(L, S) expert records in one uint8 buffer (module docstring), plus
    ``extra`` records after them that every layer can address: the
    pool's overflow tier.  Layer ``l``'s view (:meth:`served`) covers its
    own S records and everything after them, so record ``(L - l) * S + o``
    of that view is extra record ``o``, and one slot map reads pool and
    overflow alike."""

    def __init__(self, layout: RecordLayout, n_layers: int, n_slots: int,
                 device, *, pin: bool = False, extra: int = 0):
        self.layout = layout
        alloc = torch.empty if pin else torch.zeros  # a pinned store is filled whole
        R = layout.record_bytes
        self.flat = alloc((n_layers * n_slots + extra, R), dtype=torch.uint8,
                          device=device, pin_memory=pin)
        self.buf = self.flat[: n_layers * n_slots].view(n_layers, n_slots, R)
        self.n_extra = extra
        self.experts = layout.views(self.buf)
        self._served: List[Optional[PackedExperts]] = [None] * n_layers

    @property
    def n_layers(self) -> int:
        return self.buf.shape[0]

    @property
    def n_slots(self) -> int:
        return self.buf.shape[1]

    def layer(self, l: int) -> PackedExperts:
        """(S, ...) views of layer ``l``'s slots."""
        return self.experts.slice(l)

    def record(self, l: int, s: int) -> torch.Tensor:
        return self.buf[l, s]

    def extra_record(self, o: int) -> torch.Tensor:
        return self.flat[self.buf.shape[0] * self.buf.shape[1] + o]

    def extra_index(self, l: int, o: int) -> int:
        """Index of extra record ``o`` in layer ``l``'s :meth:`served` view."""
        return (self.n_layers - l) * self.n_slots + o

    def served(self, l: int) -> PackedExperts:
        """Views of layer ``l``'s slots and every record after them, as one
        (S_l, ...) stack: what the kernel reads by slot map."""
        if self._served[l] is None:
            self._served[l] = self.layout.views(
                self.flat[l * self.n_slots:][None]).slice(0)
        return self._served[l]

    def nbytes(self) -> int:
        return self.flat.numel()


def per_expert_nbytes(store: Tier) -> float:
    """Packed bytes of ONE expert (all three matrices): what a demand load
    or a speculative prefetch copies host->device."""
    return float(store.layout.record_bytes)


# ----------------------------------------------------------------------
# construction
def moe_layers(cfg: ModelConfig) -> List[int]:
    """Absolute indices of the MoE layers, in execution order."""
    if cfg.moe is None:
        raise ValueError("packed store targets MoE architectures")
    if any(parse_block(k)[1] == "moe" for k in cfg.tail_kinds()):
        raise ValueError("packed offloading supports fully-scanned MoE "
                         "stacks (no MoE tail layers)")
    return [l for l, k in enumerate(cfg.layer_kinds())
            if parse_block(k)[1] == "moe"]


def quantize_experts(experts: Dict[str, torch.Tensor], bits: int
                     ) -> Dict[str, hqq.QTensor]:
    """HQQ-quantize one layer's ``(E, K, N)`` expert stacks, on their
    device (the reference's ``build_store`` call shape)."""
    gs = hqq.PAPER_SCHEMES[bits]["group_size"]
    out = {}
    for name in EXPERT_MATS:
        leaf = experts[name]
        if leaf.shape[-2] % gs:
            raise ValueError(
                f"packed offloading needs expert contraction dims divisible "
                f"by the {bits}-bit group size {gs}; got {name} with "
                f"K={leaf.shape[-2]}")
        out[name] = hqq.quantize(leaf, bits)
    return out


def new_store(layout: RecordLayout, n_layers: int, n_experts: int,
              device: torch.device) -> Tier:
    """Empty host store for a pool on ``device`` (pinned when that is the
    card, so that its copies are truly asynchronous)."""
    return Tier(layout, n_layers, n_experts, "cpu", pin=device.type == "cuda")


def write_layer(store: Tier, l: int, qts: Dict[str, hqq.QTensor]) -> None:
    """Copy one layer's (E, ...) quantized leaves into the store."""
    dst = store.layer(l)
    for name, qt in zip(EXPERT_MATS, dst):
        for (_, d), (_, s) in zip(hqq.leaves(qt), hqq.leaves(qts[name])):
            d.copy_(s)


def build_store(params, cfg: ModelConfig, spec: OffloadSpec,
                device: torch.device) -> Tier:
    """Quantize every MoE layer's experts (on the device their weights
    are on) into the layer-major host store, one layer at a time."""
    layers = moe_layers(cfg)
    store = None
    for i, l in enumerate(layers):
        qts = quantize_experts(params["layers"][l]["moe"]["experts"],
                               spec.expert_bits)
        if store is None:
            store = new_store(RecordLayout.of(qts, 1), len(layers),
                              cfg.moe.num_experts, device)
        write_layer(store, i, qts)
    return store


# ----------------------------------------------------------------------
@dataclasses.dataclass
class PoolState:
    """The offload state of one generation: host-side LRU state per MoE
    layer, the device pool (with its overflow records) and staging
    tiers, the counters, and the copy machinery (side stream + one
    staging event per layer on the card)."""

    lru: List[LC.LayerCacheState]
    pool: Tier
    staging: Tier
    counts: np.ndarray             # (4,) hits, spec_hits, demand, spec_loads
    scratch: Tier                  # (1, n_spec) staging sources in flight
    copy_stream: Optional[torch.cuda.Stream]
    stage_events: List[Optional[torch.cuda.Event]]
    slot_host: torch.Tensor        # pinned int32 staging of slot maps
    slot_dev: torch.Tensor
    serve: Optional[Tier] = None   # (1, max_rows) records: the unrolled plane's
    h2d_bytes: int = 0             # bytes of h2d copies actually issued
    host_reads: int = 0            # device->host reads of routing decisions
    overflow_accesses: int = 0     # accesses served from the overflow tier


def init_pool_state(store: Tier, spec: OffloadSpec, device: torch.device,
                    max_rows: int, *, vectorized: bool = True) -> PoolState:
    """Zero-filled pool + staging tiers and cold LRU state for a store;
    ``max_rows`` bounds the (token, k) rows one acquire serves, and so
    the overflow tier: all but the last access of a batch can lose
    their slot to a later one.  A batch of at most ``cache_size``
    accesses loses none (each access is more recent than every slot the
    batch has not touched, and one of those is always the one evicted),
    so such pools get no overflow records.  A pool for the unrolled
    plane (``vectorized=False``) needs no overflow: it copies every
    access's record into a serve tier of ``max_rows`` records instead."""
    L, lay = store.n_layers, store.layout
    cuda = device.type == "cuda"
    extra = 0 if max_rows <= spec.cache_size or not vectorized else max_rows - 1
    return PoolState(
        lru=LC.init_model_state(L, spec.cache_size, spec.num_speculative),
        pool=Tier(lay, L, spec.cache_size, device, extra=extra),
        staging=Tier(lay, L, spec.num_speculative, device),
        counts=np.zeros((4,), np.int64),
        scratch=Tier(lay, 1, max(1, spec.num_speculative), device),
        copy_stream=torch.cuda.Stream(device) if cuda else None,
        stage_events=[None] * L,
        slot_host=torch.zeros((max_rows,), dtype=torch.int32, pin_memory=cuda),
        slot_dev=torch.zeros((max_rows,), dtype=torch.int32, device=device),
        serve=None if vectorized else Tier(lay, 1, max_rows, device),
    )


def read_host(st, t: torch.Tensor) -> np.ndarray:
    """The one device->host read of a layer's routing decisions; counted."""
    st.host_reads += 1
    return t.cpu().numpy()


def _h2d(st: PoolState, dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src, non_blocking=True)
    st.h2d_bytes += src.numel()


def _upload_slots(st: PoolState, index) -> torch.Tensor:
    n = len(index)
    st.slot_host[:n] = torch.as_tensor(index, dtype=torch.int32)
    slots = st.slot_dev[:n]
    slots.copy_(st.slot_host[:n], non_blocking=True)
    return slots


def served(st: PoolState, l: int, vectorized: bool = True) -> PackedExperts:
    """The (S, ...) stack the slots :func:`acquire` returned index: layer
    ``l``'s pool and overflow records, or the unrolled plane's serve tier."""
    return st.pool.served(l) if vectorized else st.serve.layer(0)


def acquire(store: Tier, st: PoolState, l: int, ids: np.ndarray,
            active: Optional[np.ndarray] = None, *,
            vectorized: bool = True) -> torch.Tensor:
    """Serve layer ``l``'s routed experts ``ids`` (T, K) from its pool:
    run the batch plan, issue the copies it implies on the current stream
    and return, for every (token, k) access of the active rows in order,
    the record that holds its expert, as an int32 device tensor indexing
    :func:`served` (the pool's ``served(l)``) for the kernel to read in
    place.  ``vectorized=False`` runs the unrolled plane instead
    (:func:`_acquire_unrolled`), on a pool state made for it.

    An access whose slot a later access of the batch takes over is served
    from the overflow tier instead, filled before the pool's writes land:
    from its old slot when the expert was resident at batch start, from
    the staging buffer of a speculative hit, or h2d from the store on a
    miss.  Each written slot is then written once, with its final
    occupant.  So every demand load moves its expert h2d exactly once,
    into its final slot or into the overflow tier, and the h2d bytes
    issued stay ``(demand_loads + spec_loads) * per_expert_nbytes``.
    Inactive rows (``active`` (T,) bool False) bypass the cache: no state
    change, no counter, no copy."""
    ev = st.stage_events[l]  # staging copies issued on the side stream
    if ev is not None:
        torch.cuda.current_stream(st.pool.buf.device).wait_event(ev)
    if not vectorized:
        return _acquire_unrolled(store, st, l, ids, active)
    T, K = ids.shape
    new_lru, delta, plan = LC.access_plan_batch(st.lru[l], ids, active)
    rows = range(T) if active is None else np.flatnonzero(active)
    # walk the accesses in order; every insertion is an event whose bytes
    # come from a staging buffer (speculative hit) or the store (miss)
    content = [("pool", s) for s in range(st.pool.n_slots)]
    served = []
    for t in rows:
        for j in range(K):
            s = int(plan.slots[t, j])
            if not plan.in_cache[t, j]:
                content[s] = (("staging", int(plan.spec_slot[t, j]))
                              if plan.in_spec[t, j]
                              else ("store", int(ids[t, j])), len(served))
            served.append((s, content[s]))
    overflow: Dict[tuple, int] = {}
    index = []
    for s, src in served:
        if content[s] == src:
            index.append(s)  # final occupant of its slot
        else:
            o = overflow.setdefault(src, len(overflow))
            index.append(st.pool.extra_index(l, o))

    def fill(dst, src):
        if src[0] == "pool":
            dst.copy_(st.pool.record(l, src[1]), non_blocking=True)
        elif src[0][0] == "staging":
            dst.copy_(st.staging.record(l, src[0][1]), non_blocking=True)
        else:
            _h2d(st, dst, store.record(l, src[0][1]))

    if len(overflow) > st.pool.n_extra:
        raise RuntimeError(f"{len(overflow)} accesses lose their slot within "
                           f"the batch; the pool has {st.pool.n_extra} "
                           f"overflow records (max_rows too small)")
    for src, o in overflow.items():  # before the writes overwrite old slots
        fill(st.pool.extra_record(o), src)
    for s, src in enumerate(content):
        if src[0] != "pool":
            fill(st.pool.record(l, s), src)
    st.lru[l] = new_lru
    st.counts += delta
    st.overflow_accesses += sum(i >= st.pool.n_slots for i in index)
    return _upload_slots(st, index)


def _acquire_unrolled(store: Tier, st: PoolState, l: int, ids: np.ndarray,
                      active: Optional[np.ndarray] = None) -> torch.Tensor:
    """The sequential data plane (the reference's ``_acquire_unrolled``,
    its offload benchmark's baseline): one token row at a time, in order, one
    :func:`~repro_torch.core.lru_cache.access_plan` per row and one copy
    per access, all on the current stream.  Access ``n`` of the active
    rows is copied into serve record ``n`` (the reference's ``pe_stack``
    of the served contents): from its pool slot on a hit, from its
    staging buffer on a speculative hit, and on a miss from the store
    (h2d, the counted demand load) into its pool slot first; every
    inserted expert's slot is written as its access happens.  Returns
    ``arange(n)`` indexing ``st.serve``; counters and LRU state are
    exactly the vectorized plane's."""
    if st.serve is None:
        raise ValueError("the unrolled plane needs a pool state made with "
                         "init_pool_state(..., vectorized=False)")
    T, K = ids.shape
    rows = range(T) if active is None else np.flatnonzero(active)
    lru = st.lru[l]
    n = 0
    for t in rows:
        lru, stats, plan = LC.access_plan(lru, ids[t])
        for j in range(K):
            s = int(plan.slots[j])
            slot, dst = st.pool.record(l, s), st.serve.record(0, n)
            if plan.in_cache[j]:
                dst.copy_(slot, non_blocking=True)
            elif plan.in_spec[j]:
                dst.copy_(st.staging.record(l, int(plan.spec_slot[j])),
                          non_blocking=True)
                slot.copy_(dst, non_blocking=True)
            else:
                _h2d(st, slot, store.record(l, int(ids[t, j])))
                dst.copy_(slot, non_blocking=True)
            n += 1
        st.counts += (stats.hits, stats.spec_hits, stats.demand_loads, 0)
    st.lru[l] = lru
    return _upload_slots(st, range(n))


def stage(store: Tier, st: PoolState, tgt: int, predicted: np.ndarray, *,
          vectorized: bool = True, overlap: bool = True) -> None:
    """Stage ``predicted`` (n_spec,) experts into layer ``tgt``'s staging
    buffers (the paper's speculative prefetch).  Sources follow
    :func:`~repro_torch.core.lru_cache.stage_plan`: predictions resident
    nowhere stream from the host store (and count as transfers); the rest
    copy device-locally from the pool or the previous staging buffers.
    With ``overlap`` (the pipelined plane) the copies run, on the card, on
    the side stream after everything the compute stream has queued so
    far, and an event marks their end for :func:`acquire`; without it
    they run on the current stream, in its order.  ``predicted`` holds
    distinct expert ids (a top-k).

    ``vectorized=False`` (the unrolled plane) copies every buffer, as
    the reference's per-buffer loop does: the previous staging
    contents that are sources go aside first (read before any write),
    then each buffer is filled from its pool slot, the set-aside old
    buffer or the store (h2d, exactly the counted loads).  The vectorized
    plane copies only what moves."""
    pred = [int(e) for e in predicted]
    if min(pred) < 0 or len(set(pred)) != len(pred):
        raise ValueError(f"predictions must be distinct expert ids: {pred}")
    new_lru, plan, transfers = LC.stage_plan(st.lru[tgt], predicted)
    side = st.copy_stream if overlap else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(side.device))
    with (torch.cuda.stream(side) if side is not None
          else contextlib.nullcontext()):
        n = len(pred)
        # previous staging contents about to be overwritten go aside first
        moves = [j for j in range(n) if plan.in_old_spec[j]
                 and (not vectorized or plan.old_spec_slot[j] != j)]
        for j in moves:
            st.scratch.record(0, j).copy_(
                st.staging.record(tgt, int(plan.old_spec_slot[j])),
                non_blocking=True)
        for j in range(n):
            dst = st.staging.record(tgt, j)
            if plan.loads[j]:
                _h2d(st, dst, store.record(tgt, pred[j]))
            elif plan.in_cache[j]:
                dst.copy_(st.pool.record(tgt, int(plan.cache_slot[j])),
                          non_blocking=True)
            elif j in moves:  # else already in place: old slot j
                dst.copy_(st.scratch.record(0, j), non_blocking=True)
        if side is not None:
            ev = st.stage_events[tgt] or torch.cuda.Event()
            ev.record(side)
            st.stage_events[tgt] = ev
    st.lru[tgt] = new_lru
    st.counts[3] += transfers


# ----------------------------------------------------------------------
def pool_coherent(store: Tier, st: PoolState) -> bool:
    """Every occupied pool slot holds exactly the store's bytes of the
    expert the LRU state says lives there (and every staging buffer those
    of its staged expert).  Synchronises the device."""
    if st.copy_stream is not None:
        torch.cuda.synchronize(st.copy_stream.device)
    for l, lru in enumerate(st.lru):
        for tier, ids in ((st.pool, lru.cache_ids), (st.staging, lru.spec_ids)):
            for s, e in enumerate(ids):
                if e < 0:
                    continue
                if not torch.equal(tier.record(l, s).cpu(),
                                   store.record(l, int(e))):
                    return False
    return True


@dataclasses.dataclass
class PrefillTier:
    """Reusable device tier of up to E expert slots that prefill fills,
    per layer, with the distinct experts its chunk routes to (h2d, never
    counted in the offload counters; ``h2d_bytes`` tracks them apart).
    ``batches`` keeps the per-expert row counts of the most recent kernel
    batches (one tuple per MoE layer call, in the tier's slot order): the
    ragged groups the grouped kernel ran."""

    tier: Tier
    h2d_bytes: int = 0
    host_reads: int = 0
    batches: Deque[Tuple[int, ...]] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256))

    @classmethod
    def for_store(cls, store: Tier, device) -> "PrefillTier":
        return cls(Tier(store.layout, 1, store.n_slots, device))

    def load(self, store: Tier, l: int, experts) -> PackedExperts:
        """Copy ``experts`` of layer ``l`` into slots 0.. and return views
        of those slots, (len(experts), ...)."""
        for u, e in enumerate(experts):
            src = store.record(l, int(e))
            self.tier.record(0, u).copy_(src, non_blocking=True)
            self.h2d_bytes += src.numel()
        return self.tier.layer(0).head(len(experts))
