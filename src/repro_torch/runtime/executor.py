"""Block execution for offloaded generation: the packed planes of the
reference's ``runtime/executor.py``.

Each layer runs its mixer (attention), then its MoE half, which routes,
reads the routed ids (and, at batch-1 decode, the lookahead layer's
predicted ids) to the host in ONE read, serves the routed experts from
the device pool and stages the lookahead layer's predicted experts.

* ``packed_pipelined``: the staging copies are issued before the
  layer's expert compute, on a side copy stream; the compute stream waits
  on that copy's event at the lookahead layer's ``acquire``: the fence
  that lets staging overlap the compute in between (the reference's
  DESIGN.md §7 overlap, made real).
* ``packed_vectorized``: the staging runs inside the layer, right after
  its MoE, on the compute stream; no side stream, no event.

``fused`` and ``vectorized`` select the data plane under either, as in
the reference: ``vectorized=False`` is its sequential baseline
(``expert_pool._acquire_unrolled``, three ``ops.dequant_matmul`` calls per
(token, k)), ``fused=False`` dequantizes the served records and runs the
gather einsums.

Prefill is chunked prefill (one chunk by default): the same mixer, and
MoE store-direct through a reusable device tier, with no pool traffic and
no counter.

Decode takes B >= 1 rows of one token each: a dense KV ring in
lock-step, or block-paged KV (``state["pages"]``) at per-row positions
with an ``active`` row mask, the continuous engine's batch.  A paged
step's positions, page table, write indices and ragged work lists are
built once on the host and uploaded in one copy
(``layers.paged_step``); :meth:`prefill_chunk_row` writes one slot's
prompt chunk into its pages.

The ``plain`` plane (dense resident weights) and C > 1 verify chunks
are not ported (ROADMAP queue 1, items 6 and 9).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OffloadSpec, parse_block
from repro_torch.core import expert_pool as EP
from repro_torch.core.trace import stacked_routers
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PLANES = ("plain", "packed_vectorized", "packed_pipelined")


class Executor:
    """Packed-plane executor (module docstring).  ``store`` is the packed
    host store of ``quantize_for_offload``."""

    def __init__(self, params, cfg: ModelConfig, *, spec: OffloadSpec,
                 store: EP.Tier, device=None,
                 plane: str = "packed_pipelined", fused: bool = True,
                 vectorized: bool = True):
        if plane not in PLANES:
            raise ValueError(f"unknown plane {plane!r}; one of {PLANES}")
        if plane == "plain":
            raise NotImplementedError(
                "the plain plane (dense resident weights) is ROADMAP queue 1 "
                "item 6")
        T.check_supported(cfg)
        self.plane = plane
        self.pipelined = plane == "packed_pipelined"
        self.fused = fused
        self.vectorized = vectorized
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.store = store
        self.device = resolve_device(device)
        self.routers = stacked_routers(params, cfg)
        self.n_moe_layers = int(self.routers.shape[0])
        self.kinds = cfg.layer_kinds()
        self.moe_ordinal: Dict[int, int] = {}
        for l, k in enumerate(self.kinds):
            if parse_block(k)[1] == "moe":
                self.moe_ordinal[l] = len(self.moe_ordinal)
        self.prefill_tier = EP.PrefillTier.for_store(store, self.device)
        # one ragged work list per distinct attention window
        self.windows = tuple(dict.fromkeys(T.attention_window(cfg, k)
                                           for k in self.kinds))
        self.staging = L.HostStaging()

    # ------------------------------------------------------------------
    def init_state(self, batch: int, max_len: int):
        return T.init_decode_state(self.cfg, batch, max_len, self.device)

    def init_pool_state(self, max_rows: int = 1) -> EP.PoolState:
        """Pool state for decode batches of up to ``max_rows`` rows."""
        return EP.init_pool_state(self.store, self.spec, self.device,
                                  max_rows=max_rows * self.cfg.moe.top_k,
                                  vectorized=self.vectorized)

    def _paged_step(self, state, active, C: int, rows=slice(None)):
        """The step's :class:`~repro_torch.models.layers.PagedStep` over
        the state's table rows ``rows``, from its host positions."""
        return L.paged_step(state["pos"][rows], state["pages"][rows], active,
                            C, state["layers"][0]["kv"]["ppos"].shape[1],
                            self.device, self.windows, self.staging)

    # ------------------------------------------------------------------
    def decode(self, state, tokens, pstate, active=None):
        """One decode step of B rows: tokens (B, 1) int on the device.
        ``state`` is a dense ring state (the rows in lock-step) or a paged
        one (``"pages"``), where ``active`` (B,) numpy bool marks the rows
        that write KV, go through the expert pool and advance ``pos``;
        the others compute nothing that is kept.  Speculative staging
        runs only for a single row (on the side stream on the pipelined
        plane, inside the layer otherwise).  KV and ``pstate`` are updated in
        place.  Returns ``(logits (B, 1, V), state, pstate, route_ids)``
        with every row's routed ids of every MoE layer as host arrays."""
        B, C = tokens.shape
        if C != 1:
            raise NotImplementedError(
                "C > 1 decode rows (speculative verify chunks) are ROADMAP "
                "queue 1 item 9")
        cfg, spec = self.cfg, self.spec
        paged = "pages" in state
        step = self._paged_step(state, active, C) if paged else None
        rows_dev = step.rows if paged else None
        n_spec = spec.num_speculative if B * C == 1 else 0
        x = T.embed_tokens(self.params, cfg, tokens)
        pos = state["pos"]
        route_ids = []
        for l, kind in enumerate(self.kinds):
            p = T.layer_params(self.params, cfg, l)
            st_l = state["layers"][l]
            x, st_l, h2 = T.decode_block_packed_mixer(p, cfg, kind, x, st_l,
                                                      pos, step=step)
            x, pstate, info = T.decode_block_packed_moe(
                p, cfg, x, h2, self.store, pstate, self.moe_ordinal[l],
                self.routers, lookahead=spec.lookahead, n_spec=n_spec,
                active=active, rows_dev=rows_dev, fused=self.fused,
                vectorized=self.vectorized, overlap=self.pipelined)
            route_ids.append(info["route"]["ids"])
            state["layers"][l] = st_l
        logits = T.apply_head(self.params, cfg, x)
        if paged:
            adv = C if active is None else np.where(active, C, 0)
            pos = (pos + adv).astype(np.int32)
        else:
            pos = pos + C
        return logits, dict(state, pos=pos), pstate, route_ids

    # ------------------------------------------------------------------
    def prefill_chunk(self, state, tokens):
        """Prompt chunk ``tokens`` (1, C) at the current position: KV
        written at ``pos .. pos+C-1``, ``pos`` advances by C.  Returns
        ``(logits (1, C, V), state)``; the pool is not involved."""
        cfg = self.cfg
        x = T.embed_tokens(self.params, cfg, tokens)
        pos = state["pos"]
        for l, kind in enumerate(self.kinds):
            p = T.layer_params(self.params, cfg, l)
            x, st_l, h2 = T.decode_block_packed_mixer(
                p, cfg, kind, x, state["layers"][l], pos)
            x, _ = T.prefill_block_packed_moe(p, cfg, x, h2, self.store,
                                              self.moe_ordinal[l],
                                              self.prefill_tier,
                                              fused=self.fused)
            state["layers"][l] = st_l
        logits = T.apply_head(self.params, cfg, x)
        state["pos"] = pos + int(tokens.shape[1])
        return logits, state

    def prefill_chunk_row(self, state, tokens, slot: int):
        """One slot's prompt chunk against the shared page pools: tokens
        (1, C) write KV straight into the pages ``slot`` owns at its
        position, MoE runs store-direct through the prefill tier, and
        only that row's ``pos`` advances.  Returns ``(logits (1, C, V),
        state)``; there is no install step, the running batch reads the
        pools the chunk wrote."""
        if "pages" not in state:
            raise ValueError("prefill_chunk_row needs a paged-KV state")
        cfg = self.cfg
        C = int(tokens.shape[1])
        step = self._paged_step(state, None, C, slice(slot, slot + 1))
        x = T.embed_tokens(self.params, cfg, tokens)
        for l, kind in enumerate(self.kinds):
            p = T.layer_params(self.params, cfg, l)
            x, st_l, h2 = T.decode_block_packed_mixer(
                p, cfg, kind, x, state["layers"][l], None, step=step)
            x, _ = T.prefill_block_packed_moe(p, cfg, x, h2, self.store,
                                              self.moe_ordinal[l],
                                              self.prefill_tier,
                                              fused=self.fused)
            state["layers"][l] = st_l
        logits = T.apply_head(self.params, cfg, x)
        pos = state["pos"].copy()
        pos[slot] += C
        return logits, dict(state, pos=pos)

    def prefill(self, tokens, max_len: int, *, chunk: Optional[int] = None):
        """Whole-prompt prefill = chunked prefill over a fresh state.
        Returns (logits of the last chunk, state)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        C = S if chunk is None else max(1, min(int(chunk), S))
        state = self.init_state(B, max_len)
        logits = None
        for lo in range(0, S, C):
            logits, state = self.prefill_chunk(state, tokens[:, lo: lo + C])
        return logits, state
