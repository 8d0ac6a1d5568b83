"""KV slots for continuous batching (port of the reference's
``serving/kv_manager.py``: ``KVSlotManager``, ``PagePool``,
``PagedKVManager`` and ``StateManager``).

:class:`KVSlotManager` is the dense plane: one preallocated decode state
of ``n_slots`` rows, each slot a ring of ``slot_len`` positions (the
window's width on SWA layers) at its own position.  A request's prompt
prefills into a fresh B = 1 row state (:meth:`KVSlotManager.new_row_state`)
that :meth:`KVSlotManager.write_prefill` copies into its slot's row;
nothing else in the batch is touched, and ring entries at position -1
are invisible to attention, so a freed slot needs no scrubbing.

On the paged plane KV lives in one pool of fixed-size pages per
attention layer (``models/layers.init_paged_attn_cache``) and each slot
owns an ordered page list, recorded in one page table shared by all
layers:

* a request reserves ``ceil((prompt + max_new) / page_size)`` pages at
  admission, so a mid-decode allocation never fails (no preemption);
* admission chunks write straight into the slot's pages: there is no
  side state and no install copy;
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

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


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
        ``slot``: every layer's ring row and the slot's position."""
        width = small_state["layers"][0]["kv"]["k"].shape[1]
        slot_width = self.state["layers"][0]["kv"]["k"].shape[1]
        if width != slot_width:
            raise ValueError(
                f"prefill state width {width} != slot width {slot_width}; "
                f"prefill with max_len == slot_len")
        for big, small in zip(self.state["layers"], small_state["layers"]):
            for name, t in big["kv"].items():
                t[slot] = small["kv"][name][0]
        pos = self.state["pos"].copy()
        pos[slot] = int(np.reshape(small_state["pos"], -1)[0])
        self.state = dict(self.state, pos=pos)

    def snapshot(self, slot: int):
        raise _not_ported("KVSlotManager.snapshot (recurrent rollback)", 6)

    def restore(self, small_state, slot: int) -> None:
        raise _not_ported("KVSlotManager.restore (recurrent rollback)", 6)

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
    """Host-side page allocator: heap free list + per-slot ordered page
    lists + admission reservations.  Pages are allocated lazily
    (:meth:`ensure` covers positions as they are written) but admission
    reserves a slot's worst case up front.  Invariants: free + owned
    partition the pool, and no slot owns more than it reserved."""

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        self.owned: Dict[object, List[int]] = {}
        self.reserved: Dict[object, int] = {}
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

    def reserve(self, slot, n_tokens: int) -> None:
        need = self.pages_for(n_tokens)
        if not self.can_reserve(need):
            raise ValueError(
                f"page pool exhausted: need {need} pages, "
                f"{self.n_free - self.n_reserved_unallocated} unreserved")
        assert slot not in self.reserved, f"slot {slot} already reserved"
        self.reserved[slot] = need
        self.owned[slot] = []
        self.peak_committed = max(
            self.peak_committed,
            self.n_pages - self.n_free + self.n_reserved_unallocated)

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
            new.append(pid)
        self.peak_in_use = max(self.peak_in_use, self.n_pages - self.n_free)
        return new

    def release(self, slot) -> List[int]:
        """Free every page the slot owns; returns them (for scrubbing)."""
        ids = self.owned.pop(slot, [])
        self.reserved.pop(slot, None)
        for pid in ids:
            heapq.heappush(self._free, pid)
        return ids

    def trim(self, slot, n_tokens: int) -> List[int]:
        """Give back the pages beyond ``pages_for(n_tokens)`` (a rejected
        verify chunk), keeping the reservation: the request may regrow
        into it.  Returns the freed page ids, highest ordinal first, for
        scrubbing."""
        keep = self.pages_for(n_tokens)
        assert slot in self.owned, f"slot {slot} not reserved"
        freed = []
        while len(self.owned[slot]) > keep:
            pid = self.owned[slot].pop()
            heapq.heappush(self._free, pid)
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


class PagedKVManager:
    """Block-paged slotted decode state: ``allocate`` / ``release`` /
    per-row positions over per-layer page pools indexed through one
    host-authoritative page table (module docstring)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, page_size: int,
                 pages_total: int, max_pages_per_slot: int, *,
                 device=None, bucket: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
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

    @property
    def _pages_np(self) -> np.ndarray:
        return self.state["pages"]

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return bool(self._free) and self.pool.can_reserve(
            self.pool.pages_for(n_tokens))

    def allocate(self, owner=None, n_tokens: int = 1) -> int:
        """Claim a slot and reserve its worst-case page budget; its
        position resets to 0."""
        slot = heapq.heappop(self._free)
        self.pool.reserve(slot, n_tokens)
        self._owner[slot] = owner
        self._len[slot] = 0
        pos = self.state["pos"].copy()
        pos[slot] = 0
        self.state = dict(self.state, pos=pos)
        return slot

    def release(self, slot: int) -> None:
        assert self._owner[slot] is not None, f"slot {slot} already free"
        ids = self.pool.release(slot)
        self._pages_np[slot] = -1
        self._scrub(ids)
        self._owner[slot] = None
        self._len[slot] = 0
        heapq.heappush(self._free, slot)

    def remaining(self, slot: int) -> int:
        return self.slot_len - self._len[slot]

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's page list to cover positions < n_tokens."""
        new = self.pool.ensure(slot, n_tokens)
        base = len(self.pool.owned[slot]) - len(new)
        for j, pid in enumerate(new):
            self._pages_np[slot, base + j] = pid

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Roll the slot back so exactly ``n_tokens`` positions are live
        (a rejected verify chunk): the pages past ``pages_for(n_tokens)``
        go back to the pool, their table entries to -1 and their ``ppos``
        to -1 (a reused page must not leak the rejected positions into
        another row's mask), and the position and length mirror reset.
        Entries of a kept page past ``n_tokens`` stay, hidden by kpos >
        qpos until the real tokens overwrite them.  The slot's table is
        then what non-speculative decode at that position holds."""
        assert 0 <= n_tokens <= self._len[slot], \
            f"truncate({slot}, {n_tokens}) would extend, not roll back"
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

    def _scrub(self, page_ids: List[int]) -> None:
        """Reset ``ppos`` of released pages to -1 in every layer."""
        if not page_ids:
            return
        idx = self._staging.upload(np.asarray(page_ids), self.device).long()
        for blk in self.state["layers"]:
            blk["kv"]["ppos"][idx] = -1

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

    def check_invariants(self) -> None:
        """Step-boundary audit: the free heap and the owned pages
        partition the pool; every slot's table row mirrors its owned list,
        gapless, -1 past the end; no slot owns more than it reserved; the
        free slots and the owner map partition the slots."""
        pool = self.pool
        free = sorted(pool._free)
        owned = [pid for ids in pool.owned.values() for pid in ids]
        assert len(set(free)) == len(free), f"free heap duplicates: {free}"
        assert len(set(owned)) == len(owned), "a page owned twice"
        assert not set(free) & set(owned), "pages both free and owned"
        assert set(free) | set(owned) == set(range(pool.n_pages)), \
            "pages neither free nor owned"
        assert set(pool.owned) == set(pool.reserved), \
            "reservation/ownership slot sets diverge"
        for slot, ids in pool.owned.items():
            assert len(ids) <= pool.reserved[slot], \
                f"slot {slot} owns {len(ids)} pages over its reservation"
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
    slot rings (:class:`KVSlotManager`) or, with ``kv_page``, block-paged
    KV (:class:`PagedKVManager`)."""

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
