"""Radix-style prefix index over immutable full KV pages (port of the
reference's ``serving/prefix_cache.py``, kept as the port's own copy).

Requests that share a prompt prefix (a system prompt, few-shot examples)
share the pages that hold its KV, and their prefill starts at the point
where they diverge.  This is safe without copy-on-write:

* the KV at position ``p`` depends only on tokens ``[0..p]``, so a FULL
  page of prompt KV is a function of the token block that produced it.
  Pages are keyed by their token bytes along a hash chain: node key =
  ``(parent_serial, block_bytes)``;
* only full pages are indexed, and :meth:`PrefixCache.lookup` caps the
  match at ``((len(prompt) - 1) // page_size) * page_size``: the last
  prompt token is always recomputed (its logits give the first sampled
  token), and every KV write a request makes lands past the matched
  prefix, in pages it allocated itself.  A shared page is never written.

The cache holds one reference per indexed page (``PagePool.incref``,
taken by the caller for the ``registered`` pages :meth:`insert` returns);
adopters hold their own.  A page is freed, and scrubbed, only when its
last reference drops.  Eviction is leaf-first LRU: only a childless node
can go (an interior node's page is reached through its descendants).

The index is host-side bookkeeping only; it never touches the device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["PrefixCache"]


@dataclass
class _Node:
    key: Tuple[int, bytes]
    serial: int          # monotonic id; 0 is the (virtual) root
    parent: int          # the parent's serial, 0 at depth 0
    page: int            # device page holding this ordinal's KV
    children: int = 0
    tick: int = 0        # LRU clock


class PrefixCache:
    """Hash-chain prefix index: one node per (prefix, page ordinal)."""

    def __init__(self, page_size: int, capacity_pages: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if capacity_pages < 1:
            raise ValueError(
                f"prefix cache needs capacity >= 1 page, got "
                f"{capacity_pages} (pass 0 upstream to disable the cache)")
        self.page_size = int(page_size)
        self.capacity = int(capacity_pages)
        self._nodes: Dict[Tuple[int, bytes], _Node] = {}
        self._by_serial: Dict[int, _Node] = {}
        self._serial = itertools.count(1)
        self._tick = itertools.count(1)
        # hit tokens are counted by the engine: a stalled admission looks
        # up again every step and must not count twice
        self.lookups = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    @property
    def n_pages(self) -> int:
        return len(self._nodes)

    def pages(self) -> List[int]:
        """Every page the index holds a reference on (one per node): the
        cache's share of the step-boundary refcount audit."""
        return [nd.page for nd in self._nodes.values()]

    def _key(self, parent: int, tokens: np.ndarray,
             ordinal: int) -> Tuple[int, bytes]:
        ps = self.page_size
        block = np.ascontiguousarray(
            tokens[ordinal * ps:(ordinal + 1) * ps], dtype=np.int32)
        return (parent, block.tobytes())

    def lookup(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest cached full-page prefix of ``tokens``: ``(matched
        tokens, page ids)``, ``matched == len(page_ids) * page_size``,
        capped so the last prompt token is never part of the match."""
        tokens = np.asarray(tokens)
        self.lookups += 1
        limit = max(0, (len(tokens) - 1) // self.page_size)
        parent, pids, path = 0, [], []
        for o in range(limit):
            node = self._nodes.get(self._key(parent, tokens, o))
            if node is None:
                break
            path.append(node)
            pids.append(node.page)
            parent = node.serial
        tick = next(self._tick)
        for node in path:          # refresh the whole matched chain
            node.tick = tick
        return len(pids) * self.page_size, pids

    def insert(self, tokens: np.ndarray,
               page_ids: List[int]) -> Tuple[List[int], List[int]]:
        """Index the full-page prefix chain of ``tokens``; ``page_ids[o]``
        is the prefilled page of ordinal ``o``.  Returns ``(registered,
        evicted)``: the caller increfs every registered page BEFORE it
        releases the evicted ones (a small capacity can evict a node this
        very call registered).  An ordinal whose node exists is skipped (a
        concurrent duplicate prefill keeps its own, equal, pages)."""
        tokens = np.asarray(tokens)
        n = min(len(page_ids), len(tokens) // self.page_size)
        parent, registered = 0, []
        for o in range(n):
            key = self._key(parent, tokens, o)
            node = self._nodes.get(key)
            if node is None:
                node = _Node(key=key, serial=next(self._serial),
                             parent=parent, page=int(page_ids[o]),
                             tick=next(self._tick))
                self._nodes[key] = node
                self._by_serial[node.serial] = node
                if parent:
                    self._by_serial[parent].children += 1
                registered.append(node.page)
                self.inserted_pages += 1
            else:
                node.tick = next(self._tick)
            parent = node.serial
        evicted: List[int] = []
        while len(self._nodes) > self.capacity:
            pids = self.evict_lru()
            if not pids:
                break
            evicted.extend(pids)
        return registered, evicted

    def evict_lru(self, n_nodes: int = 1) -> List[int]:
        """Drop up to ``n_nodes`` oldest childless nodes, ties broken by
        serial; returns their pages (the caller decrefs: a page a live
        slot still maps survives until its last reference drops)."""
        out: List[int] = []
        for _ in range(n_nodes):
            leaves = [nd for nd in self._nodes.values() if nd.children == 0]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: (nd.tick, nd.serial))
            del self._nodes[victim.key]
            del self._by_serial[victim.serial]
            if victim.parent:
                self._by_serial[victim.parent].children -= 1
            out.append(victim.page)
            self.evicted_pages += 1
        return out

    def stats(self) -> Dict[str, int]:
        return {"nodes": len(self._nodes),
                "cached_pages": len(self._nodes),
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages}
