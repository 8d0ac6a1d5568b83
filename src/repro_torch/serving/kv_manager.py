"""KV slots for continuous batching (port of the reference's
``serving/kv_manager.py``: ``KVSlotManager``, ``PagePool``,
``PagedKVManager`` and ``StateManager``).

:class:`KVSlotManager` is the dense plane: one preallocated decode state
of ``n_slots`` rows, each slot a ring of ``slot_len`` positions (the
window's width on SWA layers) at its own position.  A request's prompt
prefills into a fresh B = 1 row state (:meth:`KVSlotManager.new_row_state`)
that :meth:`KVSlotManager.write_prefill` copies into its slot's row;
nothing else in the batch is touched, and ring entries at position -1
are invisible to attention, so a freed slot needs no scrubbing.  A
recurrent layer's carry rides in the same rows (the reference's "rec"
plane, fixed-size, never paged): the install overwrites it, and
:meth:`KVSlotManager.snapshot` / :meth:`KVSlotManager.restore` copy a
slot's whole row out and back, the rollback of draft-and-verify on such
a stack.  An encoder-decoder's encoder-KV plane (``state["enc_kv"]``,
batch-indexed, never paged) rides likewise: admission encodes into the row
state, the install copies its row, and on pages
:meth:`PagedKVManager.write_enc_kv` writes the slot's row before the first
admission chunk.  Every admission overwrites its row whole, so a freed
slot's row needs no scrub.

On the paged plane KV lives in one pool of fixed-size pages per
attention layer (``models/layers.init_paged_attn_cache``) and each slot
owns an ordered page list, recorded in one page table shared by all
layers:

* a request reserves ``ceil((prompt + max_new) / page_size)`` pages at
  admission, so a mid-decode allocation never fails; under preemption it
  reserves its prompt and grows page by page (:meth:`PagedKVManager.grow`),
  and a preempted slot's pages are staged to pinned host memory
  (:meth:`PagedKVManager.swap_out`, budgeted by :class:`HostPagePool`) and
  copied back into fresh pages on resume (:meth:`PagedKVManager.swap_in`);
* pages are refcounted (:class:`PagePool`): a prefix-cache hit maps the
  cache's pages as a slot's leading ordinals, and a page is freed, and
  scrubbed, only when its last holder lets go;
* admission chunks write straight into the slot's pages (and a recurrent
  layer's carry into the slot's dense row, zeroed at allocation): there
  is no side state and no install copy;
* only attention layers hold pages: a pure-recurrent stack reserves none;
* a decode step's table is sliced to the live page horizon
  (:meth:`PagedKVManager.live_width`) for the plain path; the kernel's
  work list skips dead pages anyway.

On both planes every row's position (and the page table) is
host-authoritative numpy, so a step's positions and work list never
need a device read.  ``truncate`` rolls a slot back after a rejected
draft-and-verify chunk: a position reset on dense rings; on pages also
the pages past the new length go back to the pool (``PagePool.trim``,
keeping the reservation) and are scrubbed.  Released pages have ``ppos`` scrubbed to -1 in
every layer before reuse: the kernel trusts ``ppos``, so a stale
position would leak another request's keys into a new row's attention.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _kv_layers(state):
    """The KV planes of a state's attention layers (recurrent layers hold
    a ``rec`` plane instead)."""
    return [blk["kv"] for blk in state["layers"] if "kv" in blk]


def _rec_layers(state):
    return [blk["rec"] for blk in state["layers"] if "rec" in blk]


class KVSlotManager:
    """Free list over the batch axis of one preallocated dense decode
    state (module docstring): heap free list (lowest slot first), owners,
    and per-row positions kept on the host."""

    def __init__(self, cfg: ModelConfig, n_slots: int, slot_len: int, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.slot_len = slot_len
        self.state = T.init_decode_state(cfg, n_slots, slot_len, self.device)
        self.state["pos"] = np.zeros((n_slots,), np.int32)
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self._owner: List[Optional[object]] = [None] * n_slots
        self.peak_slots = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    def owner(self, slot: int):
        return self._owner[slot]

    def allocate(self, owner=None) -> int:
        slot = heapq.heappop(self._free)
        self._owner[slot] = owner
        self.peak_slots = max(self.peak_slots, self.n_slots - self.n_free)
        return slot

    def release(self, slot: int) -> None:
        assert self._owner[slot] is not None, f"slot {slot} already free"
        self._owner[slot] = None
        heapq.heappush(self._free, slot)

    def remaining(self, slot: int) -> int:
        """Decode steps this slot can still take before its ring would
        overwrite live context (conservative where the window is
        narrower than the slot)."""
        return self.slot_len - int(self.state["pos"][slot])

    def new_row_state(self):
        """A fresh B = 1 decode state of slot width: chunked admission
        writes each prompt chunk into it at the chunk's offset while the
        batch decodes, then :meth:`write_prefill` installs it."""
        return T.init_decode_state(self.cfg, 1, self.slot_len, self.device)

    def write_prefill(self, small_state, slot: int) -> None:
        """Install a prefilled B = 1 state (``max_len == slot_len``) into
        ``slot``: every layer's ring row or recurrent carry, and the
        slot's position.  The width is checked on the first layer that has
        a ring (a hybrid may lead with recurrent layers)."""
        rings = _kv_layers(self.state)
        if rings:
            width = _kv_layers(small_state)[0]["k"].shape[1]
            slot_width = rings[0]["k"].shape[1]
            if width != slot_width:
                raise ValueError(
                    f"prefill state width {width} != slot width {slot_width}; "
                    f"prefill with max_len == slot_len")
        self._write(small_state, slot)

    def _write(self, small_state, slot: int) -> None:
        for big, small in zip(self.state["layers"], small_state["layers"]):
            for name, plane in big.items():
                for k, t in plane.items():
                    t[slot] = small[name][k][0]
        for k, t in self.state.get("enc_kv", {}).items():
            t[:, slot] = small_state["enc_kv"][k][:, 0]
        pos = self.state["pos"].copy()
        pos[slot] = int(np.reshape(small_state["pos"], -1)[0])
        self.state = dict(self.state, pos=pos)

    def snapshot(self, slot: int):
        """A B = 1 copy of the slot's whole state (every layer's ring row
        and recurrent carry, its encoder-KV row, and its position): the
        pre-round snapshot of draft-and-verify on a stack with recurrent
        layers, whose carries cannot roll back by a position reset."""
        snap = {"layers": [{name: {k: t[slot: slot + 1].clone()
                                   for k, t in plane.items()}
                            for name, plane in blk.items()}
                           for blk in self.state["layers"]],
                "pos": self.state["pos"][slot: slot + 1].copy()}
        if "enc_kv" in self.state:
            snap["enc_kv"] = {k: t[:, slot: slot + 1].clone()
                              for k, t in self.state["enc_kv"].items()}
        return snap

    def restore(self, small_state, slot: int) -> None:
        """Write a :meth:`snapshot` (or a continuation of one) back into
        ``slot``: the restore half of the recurrent rollback."""
        self._write(small_state, slot)

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Roll the slot back so exactly ``n_tokens`` positions are live
        (a rejected verify chunk): a position reset only.  Ring entries
        at positions >= ``n_tokens`` carry kpos > qpos for every later
        query, so the attention mask hides them, and the next real token
        overwrites the same ring slot.  Valid while the ring has never
        wrapped, which the speculative engines guarantee."""
        assert 0 <= n_tokens <= int(self.state["pos"][slot]), \
            f"truncate({slot}, {n_tokens}) would extend, not roll back"
        pos = self.state["pos"].copy()
        pos[slot] = n_tokens
        self.state = dict(self.state, pos=pos)

    def metrics(self) -> Dict[str, object]:
        """KV occupancy, the reference's ``layout: "dense"`` keys: every
        occupied slot reserves ``slot_len`` positions whether used or
        not (the waste the paged plane removes); live positions from the
        host mirror."""
        live = [int(self.state["pos"][s]) for s in range(self.n_slots)
                if self._owner[s] is not None]
        return {"layout": "dense",
                "slots_in_use": self.n_slots - self.n_free,
                "slots_free": self.n_free,
                "positions_reserved":
                    (self.n_slots - self.n_free) * self.slot_len,
                "peak_positions_reserved": self.peak_slots * self.slot_len,
                "positions_live": sum(live),
                "slot_lengths": live}

    def stats(self) -> Dict[str, object]:
        """Flat projection of :meth:`metrics` (``kv_*`` keys)."""
        return {f"kv_{k}": v for k, v in self.metrics().items()}

    def check_invariants(self, cache_pages=()) -> None:
        """The free list and the owner map partition the slots."""
        free = sorted(self._free)
        assert len(set(free)) == len(free), \
            f"free list holds duplicates: {free}"
        owned = {s for s in range(self.n_slots)
                 if self._owner[s] is not None}
        assert not (set(free) & owned), \
            f"slots both free and owned: {sorted(set(free) & owned)}"
        assert set(free) | owned == set(range(self.n_slots)), \
            "slot free list + owner map do not cover all slots"


class PagePool:
    """Host-side page allocator: heap free list, per-slot ordered page
    lists, admission reservations and per-page reference counts.  Pages
    are allocated lazily (:meth:`ensure` covers positions as they are
    written) against a reservation made at admission (the worst case, or
    under preemption the prompt, grown step by step).  With a prefix
    cache a page can be held by several slots and the cache at once: a
    slot's release drops its references and frees (and returns for
    scrubbing) only the pages whose last reference dropped.  Invariants:
    free + referenced partition the pool, no slot owns more than it
    reserved, and every page's refcount equals its holders."""

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        self.owned: Dict[object, List[int]] = {}
        self.reserved: Dict[object, int] = {}
        self.refs: Dict[int, int] = {}  # page id -> live references
        self.peak_in_use = 0
        # allocated + reserved-but-unallocated: the committed footprint
        self.peak_committed = 0

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_reserved_unallocated(self) -> int:
        return sum(max(0, r - len(self.owned.get(s, [])))
                   for s, r in self.reserved.items())

    def can_reserve(self, n_pages: int) -> bool:
        return n_pages <= self.n_free - self.n_reserved_unallocated

    def reserve(self, slot, n_tokens: int, prealloc_pages: int = 0) -> None:
        """``prealloc_pages``: the prefix-hit credit, leading pages of the
        reservation that will be adopted from the cache (already
        allocated), so only the rest must be unreserved, and the committed
        peak does not count them twice."""
        need = self.pages_for(n_tokens)
        if not self.can_reserve(max(0, need - prealloc_pages)):
            raise ValueError(
                f"page pool exhausted: need {need - prealloc_pages} pages, "
                f"{self.n_free - self.n_reserved_unallocated} unreserved")
        assert slot not in self.reserved, f"slot {slot} already reserved"
        self.reserved[slot] = need
        self.owned[slot] = []
        self.peak_committed = max(
            self.peak_committed,
            self.n_pages - self.n_free + self.n_reserved_unallocated
            - prealloc_pages)

    def ensure(self, slot, n_tokens: int) -> List[int]:
        """Allocate pages so positions ``0 .. n_tokens-1`` are covered;
        returns the NEWLY allocated page ids (ordinal order)."""
        need = self.pages_for(n_tokens)
        assert slot in self.owned, f"slot {slot} not reserved"
        assert need <= self.reserved[slot], \
            f"slot {slot} outgrew its reservation ({need} > " \
            f"{self.reserved[slot]} pages)"
        new = []
        while len(self.owned[slot]) < need:
            pid = heapq.heappop(self._free)
            self.owned[slot].append(pid)
            self.refs[pid] = 1
            new.append(pid)
        self.peak_in_use = max(self.peak_in_use, self.n_pages - self.n_free)
        return new

    def incref(self, pid: int) -> None:
        assert self.refs.get(pid, 0) > 0, \
            f"incref on unreferenced page {pid}"
        self.refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page was FREED (the caller
        scrubs it before reuse)."""
        n = self.refs[pid] - 1
        if n > 0:
            self.refs[pid] = n
            return False
        del self.refs[pid]
        heapq.heappush(self._free, pid)
        return True

    def adopt_shared(self, slot, page_ids: List[int]) -> None:
        """Map live (cache-held) pages as the slot's leading ordinals: the
        prefix-hit admission.  Runs right after :meth:`reserve`, whose
        reservation counts them."""
        assert slot in self.reserved and not self.owned[slot], \
            f"adopt_shared({slot}) must follow reserve() immediately"
        assert len(page_ids) <= self.reserved[slot]
        for pid in page_ids:
            self.incref(pid)
            self.owned[slot].append(pid)

    def can_grow_reservation(self, slot, n_tokens: int) -> bool:
        need = self.pages_for(n_tokens)
        cur = self.reserved.get(slot, 0)
        return (need <= cur
                or need - cur <= self.n_free - self.n_reserved_unallocated)

    def grow_reservation(self, slot, n_tokens: int) -> None:
        """Extend a slot's reservation to cover ``n_tokens``: optimistic
        admission under preemption claims pages as decode grows."""
        need = self.pages_for(n_tokens)
        cur = self.reserved[slot]
        if need <= cur:
            return
        if need - cur > self.n_free - self.n_reserved_unallocated:
            raise ValueError(
                f"page pool exhausted: slot {slot} needs {need - cur} more "
                f"pages, {self.n_free - self.n_reserved_unallocated} "
                f"unreserved")
        self.reserved[slot] = need
        self.peak_committed = max(
            self.peak_committed,
            self.n_pages - self.n_free + self.n_reserved_unallocated)

    def release(self, slot) -> List[int]:
        """Drop the slot's reference on every page it owns; returns the
        pages FREED (for scrubbing): a page the prefix cache or another
        adopter still holds stays live with its KV."""
        ids = self.owned.pop(slot, [])
        self.reserved.pop(slot, None)
        return [pid for pid in ids if self.decref(pid)]

    def trim(self, slot, n_tokens: int) -> List[int]:
        """Give back the pages beyond ``pages_for(n_tokens)`` (a rejected
        verify chunk), keeping the reservation: the request may regrow
        into it.  Returns the freed page ids, highest ordinal first, for
        scrubbing; a popped page another holder keeps is not freed."""
        keep = self.pages_for(n_tokens)
        assert slot in self.owned, f"slot {slot} not reserved"
        freed = []
        while len(self.owned[slot]) > keep:
            pid = self.owned[slot].pop()
            if self.decref(pid):
                freed.append(pid)
        return freed

    def stats(self) -> Dict[str, object]:
        return {"pages_total": self.n_pages,
                "pages_free": self.n_free,
                "pages_in_use": self.n_pages - self.n_free,
                "pages_peak_in_use": self.peak_in_use,
                "pages_peak_committed": self.peak_committed,
                "pages_reserved_unallocated": self.n_reserved_unallocated,
                "page_size": self.page_size}


class HostPagePool:
    """Budget and byte counters of the KV pages staged to host memory by
    preemption (``kv_host_pages``).  The blobs themselves live with the
    engine's preempted-request records; a zero budget makes every
    preemption drop its KV and resume by recompute."""

    def __init__(self, n_pages: int):
        assert n_pages >= 0
        self.n_pages = int(n_pages)
        self.in_use = 0
        self.peak_in_use = 0
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0

    def can_hold(self, n_pages: int) -> bool:
        return self.in_use + n_pages <= self.n_pages

    def note_out(self, n_pages: int, nbytes: int) -> None:
        self.in_use += n_pages
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.swap_out_bytes += nbytes

    def note_in(self, n_pages: int, nbytes: int) -> None:
        assert self.in_use >= n_pages
        self.in_use -= n_pages
        self.swap_in_bytes += nbytes

    def note_drop(self, n_pages: int) -> None:
        """A blob discarded without a restore (cancelled while swapped, or
        a failed h2d stage): its pages leave the budget, no bytes flow."""
        assert self.in_use >= n_pages
        self.in_use -= n_pages

    def stats(self) -> Dict[str, int]:
        return {"pages_total": self.n_pages,
                "pages_in_use": self.in_use,
                "peak_pages_in_use": self.peak_in_use,
                "swap_out_bytes": self.swap_out_bytes,
                "swap_in_bytes": self.swap_in_bytes}


class PagedKVManager:
    """Block-paged slotted decode state: ``allocate`` / ``release`` /
    per-row positions over per-layer page pools indexed through one
    host-authoritative page table (module docstring)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, page_size: int,
                 pages_total: int, max_pages_per_slot: int, *,
                 device=None, bucket: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        # only layers whose plane grows with context hold pages: a stack
        # without one (pure-recurrent) reserves no page per request and
        # admits on free slots alone
        self.has_kv = cfg.has_kv_layers
        self.n_slots = n_slots
        self.page_size = page_size
        self.max_pages = max_pages_per_slot
        self.slot_len = max_pages_per_slot * page_size  # per-request cap
        self.bucket = bucket
        self.state = T.init_decode_state(
            cfg, n_slots, self.slot_len, self.device, kv_pages=pages_total,
            kv_page=page_size, kv_max_pages=max_pages_per_slot)
        self.pool = PagePool(pages_total, page_size)
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self._owner: List[Optional[object]] = [None] * n_slots
        self._len = [0] * n_slots  # host mirror of live token counts
        self._staging = L.HostStaging()
        self.host: Optional[HostPagePool] = None  # the swap budget
        self._finj = None  # FaultInjector; None = no injection

    @property
    def _pages_np(self) -> np.ndarray:
        return self.state["pages"]

    @property
    def n_free(self) -> int:
        return len(self._free)

    def owner(self, slot: int):
        return self._owner[slot]

    def set_fault_injector(self, inj) -> None:
        """Attach (or clear) the fault plane.  Sites here: ``page_pool``
        (admission sees no headroom) and ``swap_out`` (the d2h stage
        fails: the KV is dropped and the request resumes by recompute)."""
        self._finj = inj

    def can_admit(self, n_tokens: int, prealloc_pages: int = 0) -> bool:
        """``prealloc_pages``: the prefix-hit credit, pages the request
        adopts from the cache, so only the rest of its reservation must
        be unreserved."""
        if self._finj is not None and self._finj.fires("page_pool"):
            return False  # injected exhaustion: admission retries next step
        if not self.has_kv:
            return bool(self._free)
        need = max(0, self.pool.pages_for(n_tokens) - prealloc_pages)
        return bool(self._free) and self.pool.can_reserve(need)

    def allocate(self, owner=None, n_tokens: int = 1, *, shared_pages=(),
                 base: int = 0) -> int:
        """Claim a slot and reserve pages for ``n_tokens``.  A prefix hit
        passes the cache's pages as ``shared_pages`` (the slot's leading
        ordinals, refcounted, never written) and ``base`` = the matched
        token count: the slot starts there and prefills ``[base,
        total)``.  Otherwise its position resets to 0.  No page is reserved
        on a stack without KV layers.  A reused slot's recurrent carries
        are zeroed (chunks write them in place, so nothing else would)."""
        assert base == len(shared_pages) * self.page_size
        slot = heapq.heappop(self._free)
        if self.has_kv:
            self.pool.reserve(slot, n_tokens,
                              prealloc_pages=len(shared_pages))
            if shared_pages:
                self.pool.adopt_shared(slot, list(shared_pages))
                self._pages_np[slot, :len(shared_pages)] = shared_pages
        self._owner[slot] = owner
        self._len[slot] = base
        pos = self.state["pos"].copy()
        pos[slot] = base
        self.state = dict(self.state, pos=pos)
        for rec in _rec_layers(self.state):
            for t in rec.values():
                t[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        """Free the slot; only the pages whose last reference dropped are
        scrubbed (a page the cache still holds keeps its KV)."""
        assert self._owner[slot] is not None, f"slot {slot} already free"
        ids = self.pool.release(slot)
        self._pages_np[slot] = -1
        self._scrub(ids)
        self._owner[slot] = None
        self._len[slot] = 0
        heapq.heappush(self._free, slot)

    def free_cached_pages(self, page_ids: List[int]) -> List[int]:
        """Drop the prefix cache's reference on evicted pages; the pages
        whose last reference this was are freed and scrubbed.  Returns
        them."""
        freed = [pid for pid in page_ids if self.pool.decref(pid)]
        self._scrub(freed)
        return freed

    def remaining(self, slot: int) -> int:
        return self.slot_len - self._len[slot]

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's page list to cover positions < n_tokens."""
        if not self.has_kv:
            return
        new = self.pool.ensure(slot, n_tokens)
        base = len(self.pool.owned[slot]) - len(new)
        for j, pid in enumerate(new):
            self._pages_np[slot, base + j] = pid

    def can_grow(self, slot: int, n_tokens: int) -> bool:
        """Could the slot's reservation stretch to ``n_tokens``?  When not,
        the preempting engine frees pages first (cache eviction, then a
        victim)."""
        return not self.has_kv or self.pool.can_grow_reservation(slot,
                                                                  n_tokens)

    def grow(self, slot: int, n_tokens: int) -> None:
        """Extend the slot's reservation (optimistic admission under
        preemption) and allocate the pages that cover ``n_tokens``."""
        if not self.has_kv:
            return
        self.pool.grow_reservation(slot, n_tokens)
        self.ensure(slot, n_tokens)

    # -- host swap (preemption) ----------------------------------------
    def enable_host_swap(self, n_pages: int) -> None:
        self.host = HostPagePool(n_pages)

    def page_nbytes(self) -> int:
        """Bytes one page takes over every layer's kp/vp/ppos: the unit of
        swap traffic."""
        P = self.pool.n_pages
        return sum(t.numel() * t.element_size() // P
                   for kv in _kv_layers(self.state) for t in kv.values())

    def swap_out(self, slot: int):
        """Stage the slot's pages to host memory so the engine can release
        them: one gather per plane (kp, vp, ppos) over every layer, then
        one d2h copy each into pinned memory, on the compute stream, so
        the gather reads the pages before the release's scrub writes
        them.  Returns the blob, or None when the host budget cannot hold
        the pages or the ``swap_out`` fault fires (the engine then drops
        the KV and resumes by recompute).  Shared prefix pages survive the
        release through the cache's reference; the blob holds their
        content too, so the restore is exact either way."""
        if self.host is None or not self.has_kv:
            return None
        pids = list(self.pool.owned.get(slot, []))
        k = len(pids)
        if k == 0 or not self.host.can_hold(k):
            return None
        if self._finj is not None and self._finj.fires("swap_out"):
            return None
        idx = self._staging.upload(np.asarray(pids), self.device).long()
        pin = self.device.type == "cuda"
        data = {}
        for name in ("kp", "vp", "ppos"):
            dev = torch.stack([kv[name].index_select(0, idx)
                               for kv in _kv_layers(self.state)])
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=pin)
            data[name] = host.copy_(dev, non_blocking=pin)
        self.host.note_out(k, k * self.page_nbytes())
        return {"data": data, "n_pages": k, "n_tokens": self._len[slot]}

    def swap_in(self, owner, blob, reserve_tokens: int) -> int:
        """Re-admit a swapped request: a slot and a reservation for
        ``reserve_tokens``, exactly the blob's page count allocated, and
        the staged pages copied back (h2d) into them with ``index_copy_``
        on the compute stream, before the row's next step.  Positions,
        ordinals and ``ppos`` come back as they were, so the resumed
        decode is the uninterrupted one."""
        slot = self.allocate(owner, reserve_tokens)
        k = blob["n_pages"]
        self.ensure(slot, k * self.page_size)
        pids = self.pool.owned[slot]
        assert len(pids) == k, f"swap_in expected {k} pages, got {len(pids)}"
        idx = self._staging.upload(np.asarray(pids), self.device).long()
        pin = self.device.type == "cuda"
        for name, host in blob["data"].items():
            dev = host.to(self.device, non_blocking=pin)
            for l, kv in enumerate(_kv_layers(self.state)):
                kv[name].index_copy_(0, idx, dev[l])
        self.host.note_in(k, k * self.page_nbytes())
        n_live = blob["n_tokens"]
        self._len[slot] = n_live
        pos = self.state["pos"].copy()
        pos[slot] = n_live
        self.state = dict(self.state, pos=pos)
        return slot

    def discard_blob(self, blob) -> None:
        """Drop a blob without restoring it (cancelled while swapped, or a
        failed h2d stage): its host budget returns, no bytes flow."""
        if blob is None or self.host is None:
            return
        self.host.note_drop(blob["n_pages"])

    def host_stats(self) -> Dict[str, int]:
        host = self.host if self.host is not None else HostPagePool(0)
        return host.stats()

    # ------------------------------------------------------------------
    def truncate(self, slot: int, n_tokens: int) -> None:
        """Roll the slot back so exactly ``n_tokens`` positions are live
        (a rejected verify chunk): the pages past ``pages_for(n_tokens)``
        go back to the pool, their table entries to -1 and, when freed,
        their ``ppos`` to -1 (a reused page must not leak the rejected
        positions into another row's mask), and the position and length
        mirror reset.  Entries of a kept page past ``n_tokens`` stay,
        hidden by kpos > qpos until the real tokens overwrite them.  The
        slot's table is then what non-speculative decode at that position
        holds."""
        assert 0 <= n_tokens <= self._len[slot], \
            f"truncate({slot}, {n_tokens}) would extend, not roll back"
        if self.has_kv:
            freed = self.pool.trim(slot, n_tokens)
            self._pages_np[slot, len(self.pool.owned[slot]):] = -1
            self._scrub(freed)
        self._len[slot] = n_tokens
        pos = self.state["pos"].copy()
        pos[slot] = n_tokens
        self.state = dict(self.state, pos=pos)

    def note_tokens(self, slot: int, n_tokens: int) -> None:
        """Record the slot's live token count (the host mirror of its
        position, so per-step page sizing never reads the device)."""
        self._len[slot] = n_tokens

    def length(self, slot: int) -> int:
        return self._len[slot]

    def live_width(self, slots) -> int:
        """Page-table width covering every listed slot's allocated pages:
        the decode step's attention horizon, bucketed to the next power
        of two (the reference bounds its compiled widths so)."""
        used = max((len(self.pool.owned.get(s, [])) for s in slots),
                   default=1)
        used = max(1, used)
        if not self.bucket:
            return self.max_pages
        w = 1
        while w < used:
            w *= 2
        return min(w, self.max_pages)

    def view(self, width: Optional[int] = None):
        """The state with the page table sliced to ``width`` ordinals:
        what one decode step executes against."""
        pages = self._pages_np
        if width is not None and width < self.max_pages:
            pages = pages[:, :width]
        return dict(self.state, pages=pages)

    def adopt(self, new_state) -> None:
        """Take the pools and positions a step returned; the (possibly
        sliced) table is replaced by the full host-authoritative one."""
        self.state = dict(new_state, pages=self._pages_np)

    def write_enc_kv(self, slot: int, enc_kv) -> None:
        """Write a request's encoder-KV plane (B = 1, from
        ``Executor.encode``) into ``slot``'s row of the shared plane, in
        place: admission does it before the slot's first prompt chunk."""
        for k, t in self.state["enc_kv"].items():
            t[:, slot] = enc_kv[k][:, 0]

    def _scrub(self, page_ids: List[int]) -> None:
        """Reset ``ppos`` of freed pages to -1 in every layer."""
        if not page_ids:
            return
        idx = self._staging.upload(np.asarray(page_ids), self.device).long()
        for kv in _kv_layers(self.state):
            kv["ppos"][idx] = -1

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        """Slot occupancy from the host mirrors plus the pool's counters."""
        live = [self._len[s] for s in range(self.n_slots)
                if self._owner[s] is not None]
        out = {"layout": "paged",
               "slots_in_use": self.n_slots - self.n_free,
               "slots_free": self.n_free,
               "peak_positions_reserved":
                   self.pool.peak_committed * self.page_size,
               "positions_live": sum(live),
               "slot_lengths": live,
               "slot_pages": {s: list(self.pool.owned.get(s, []))
                              for s in range(self.n_slots)
                              if self._owner[s] is not None}}
        out.update(self.pool.stats())
        return out

    def stats(self) -> Dict[str, object]:
        """Flat projection of :meth:`metrics` (``kv_*`` keys)."""
        return {f"kv_{k}": v for k, v in self.metrics().items()}

    def check_invariants(self, cache_pages=()) -> None:
        """Step-boundary audit.  ``cache_pages``: every page the prefix
        cache holds a reference on.  Exactly: the free heap and the
        referenced pages partition the pool; every page's refcount equals
        its holders (the slots owning it plus one per cache node); every
        slot's table row mirrors its owned list, gapless, -1 past the end;
        no slot owns more than it reserved, and reservations exist exactly
        for the owning slots; the free slots and the owner map partition
        the slots."""
        pool = self.pool
        free = sorted(pool._free)
        assert len(set(free)) == len(free), f"free heap duplicates: {free}"
        live = set(pool.refs)
        assert not set(free) & live, \
            f"pages both free and referenced: {sorted(set(free) & live)}"
        missing = set(range(pool.n_pages)) - set(free) - live
        assert not missing, \
            f"pages neither free nor referenced: {sorted(missing)}"
        assert set(pool.owned) == set(pool.reserved), \
            "reservation/ownership slot sets diverge"
        holders: Dict[int, int] = {}
        for slot, ids in pool.owned.items():
            assert len(ids) <= pool.reserved[slot], \
                f"slot {slot} owns {len(ids)} pages over its reservation"
            for pid in ids:
                holders[pid] = holders.get(pid, 0) + 1
        for pid in cache_pages:
            holders[int(pid)] = holders.get(int(pid), 0) + 1
        assert holders == pool.refs, \
            f"refcounts diverge from holder counts:\n" \
            f"  holders: {dict(sorted(holders.items()))}\n" \
            f"  refs   : {dict(sorted(pool.refs.items()))}"
        for s in range(self.n_slots):
            ids = pool.owned.get(s, []) if self._owner[s] is not None else []
            row = self._pages_np[s]
            assert list(row[: len(ids)]) == list(ids), \
                f"slot {s} table row {row[:len(ids)].tolist()} != {ids}"
            assert (row[len(ids):] == -1).all(), \
                f"slot {s} table has stale ids past its {len(ids)} pages"
        free_slots = set(self._free)
        owned_slots = {s for s in range(self.n_slots)
                       if self._owner[s] is not None}
        assert not free_slots & owned_slots, "slots both free and owned"
        assert free_slots | owned_slots == set(range(self.n_slots))


class StateManager:
    """Construction point of the slot-state manager for a config: dense
    slot rings and recurrent rows (:class:`KVSlotManager`) or, with
    ``kv_page``, block-paged KV (:class:`PagedKVManager`, whose pool holds
    pages for the growing planes only: none on a pure-recurrent stack,
    which then reserves zero pages per request)."""

    @staticmethod
    def create(cfg: ModelConfig, n_slots: int, slot_len: int, *,
               kv_page: Optional[int] = None,
               kv_pages_total: Optional[int] = None,
               bucket: bool = True, device=None):
        if kv_page is None:
            if kv_pages_total is not None:
                raise ValueError("kv_pages_total needs kv_page (it sizes "
                                 "the paged pool)")
            return KVSlotManager(cfg, n_slots, slot_len, device=device)
        max_pages = -(-slot_len // kv_page)
        pages_total = (kv_pages_total if kv_pages_total is not None
                       else n_slots * max_pages)
        return PagedKVManager(cfg, n_slots, kv_page, pages_total, max_pages,
                              device=device, bucket=bucket)
