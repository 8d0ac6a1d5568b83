"""Block execution for offloaded generation: the ``packed_pipelined``
plane of the reference's ``runtime/executor.py``.

Each layer runs its mixer (attention), then its MoE half, which routes,
reads the routed ids (and, at batch-1 decode, the lookahead layer's
predicted ids) to the host in ONE read, serves the routed experts from
the device pool and issues the lookahead layer's staging on a side copy
stream.  The compute stream waits on that copy's event at the lookahead
layer's ``acquire``: the fence that lets staging overlap the compute in
between (the reference's DESIGN.md §7 overlap, made real).

Prefill is chunked prefill (one chunk by default): the same mixer, and
MoE store-direct through a reusable device tier, with no pool traffic and
no counter.

Only this plane, batch-1 rows and greedy decoding are ported; the plain
and ``packed_vectorized`` planes, T > 1 decode rows and paged KV are
ROADMAP queue-1 items.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OffloadSpec, parse_block
from repro_torch.core import expert_pool as EP
from repro_torch.core.trace import stacked_routers
from repro_torch.models import transformer as T


class Executor:
    """Packed-plane executor (module docstring).  ``store`` is the packed
    host store of ``quantize_for_offload``."""

    def __init__(self, params, cfg: ModelConfig, *, spec: OffloadSpec,
                 store: EP.Tier, device=None):
        T.check_supported(cfg)
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

    # ------------------------------------------------------------------
    def init_state(self, batch: int, max_len: int):
        return T.init_decode_state(self.cfg, batch, max_len, self.device)

    def init_pool_state(self) -> EP.PoolState:
        return EP.init_pool_state(self.store, self.spec, self.device,
                                  max_rows=self.cfg.moe.top_k)

    # ------------------------------------------------------------------
    def decode(self, state, tokens, pstate):
        """One decode step of a batch-1 row: tokens (1, 1) int on the
        device.  The KV rings, ``state["pos"]`` and ``pstate`` are updated
        in place.  Returns ``(logits (1, 1, V), state, pstate, route_ids)``
        with the routed ids of every MoE layer as host arrays."""
        B, C = tokens.shape
        if B * C != 1:
            raise NotImplementedError(
                "the port decodes batch-1 rows only; T > 1 decode rows "
                "(verify chunks, continuous batching) are ROADMAP queue 1 "
                "items 8 and 9")
        cfg, spec = self.cfg, self.spec
        x = T.embed_tokens(self.params, cfg, tokens)
        pos = state["pos"]
        route_ids = []
        for l, kind in enumerate(self.kinds):
            p = T.layer_params(self.params, cfg, l)
            st_l = state["layers"][l]
            x, st_l, h2 = T.decode_block_packed_mixer(p, cfg, kind, x, st_l,
                                                      pos)
            x, pstate, info = T.decode_block_packed_moe(
                p, cfg, x, h2, self.store, pstate, self.moe_ordinal[l],
                self.routers, lookahead=spec.lookahead,
                n_spec=spec.num_speculative)
            route_ids.append(info["route"]["ids"])
            state["layers"][l] = st_l
        logits = T.apply_head(self.params, cfg, x)
        state["pos"] = pos + C
        return logits, state, pstate, route_ids

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
                                              self.prefill_tier)
            state["layers"][l] = st_l
        logits = T.apply_head(self.params, cfg, x)
        state["pos"] = pos + int(tokens.shape[1])
        return logits, state

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
