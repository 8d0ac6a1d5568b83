"""Block execution: the three planes of the reference's
``runtime/executor.py``.

* ``plain``: dense resident weights.  Each step is
  ``transformer.decode_step``: the mixer, then the MoE by the per-token
  gather over the dense expert stack (or the dense MLP); a prompt chunk
  attends through the flash binding like the packed planes' chunks do,
  and paged states through the ragged binding.  With ``collect_info`` a
  decode step also returns every layer's routing (ids, weights,
  probabilities) and pre-MoE hidden state: what accounting mode replays,
  ``core/trace`` records and the expert-overlap admission policy reads.
  :meth:`Executor.prefill_padded` is the static engine's left-padded
  batch prefill (``transformer.prefill``: the training forward with the
  decode state).

On the packed planes each layer runs its mixer (attention), then its MoE
half, which routes, reads the routed ids (and, at batch-1 decode, the
lookahead layer's predicted ids) to the host in ONE read, serves the
routed experts from the device pool and stages the lookahead layer's
predicted experts.

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
on the packed planes MoE store-direct through a reusable device tier,
with no pool traffic and no counter.

Decode takes B >= 1 rows of C >= 1 tokens each (C = 1 in decode, C =
k + 1 in a draft-and-verify chunk, ``core/draft``): dense KV rings in
lock-step (``pos`` an int), dense rings at per-row positions (``pos`` a
host (B,) array: the continuous engine's slots and the static engine's
padded batch), or block-paged KV (``state["pages"]``) at per-row
positions; ``active`` marks the rows in use (paged rows outside it write
nothing and stay; on the packed planes they bypass the expert pool).
On the packed planes a step's B * C token rows go through one pool
acquire per MoE layer, in token-major order.  A
step's positions, row indices, page table, write indices and ragged work
lists are built once on the host and uploaded in one copy with the
step's tokens when the caller passes them as a host array
(``transformer.prepare_step``); :meth:`prefill_chunk_row` writes one
slot's prompt chunk into its pages.
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
    """Step executor of one plane (module docstring).  The packed planes
    need ``spec`` and ``store``, the packed host store of
    ``quantize_for_offload(..., pack_experts=True)``."""

    def __init__(self, params, cfg: ModelConfig, *,
                 spec: Optional[OffloadSpec] = None,
                 store: Optional[EP.Tier] = None, device=None,
                 plane: str = "plain", fused: bool = True,
                 vectorized: bool = True):
        if plane not in PLANES:
            raise ValueError(f"unknown plane {plane!r}; one of {PLANES}")
        T.check_supported(cfg)
        self.plane = plane
        self.packed = plane != "plain"
        self.pipelined = plane == "packed_pipelined"
        self.fused = fused
        self.vectorized = vectorized
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.store = store
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        self.staging = L.HostStaging()
        if not self.packed:
            return
        if spec is None or store is None:
            raise ValueError("packed planes need spec= and store= (see "
                             "quantize_for_offload)")
        self.routers = stacked_routers(params, cfg)
        self.n_moe_layers = int(self.routers.shape[0])
        self.moe_ordinal: Dict[int, int] = {}
        for l, k in enumerate(self.kinds):
            if parse_block(k)[1] == "moe":
                self.moe_ordinal[l] = len(self.moe_ordinal)
        self.prefill_tier = EP.PrefillTier.for_store(store, self.device)

    # ------------------------------------------------------------------
    def init_state(self, batch: int, max_len: int):
        return T.init_decode_state(self.cfg, batch, max_len, self.device)

    def init_pool_state(self, max_rows: int = 1) -> EP.PoolState:
        """Pool state for decode steps of up to ``max_rows`` token rows
        (B * C: rows times tokens per row)."""
        if not self.packed:
            raise ValueError("buffer pools exist on the packed planes only")
        return EP.init_pool_state(self.store, self.spec, self.device,
                                  max_rows=max_rows * self.cfg.moe.top_k,
                                  vectorized=self.vectorized)

    def _prepare(self, state, tokens, active=None, row=None):
        """The step's prepared inputs (``transformer.prepare_step``) and
        its tokens on the device: host tokens ride in the step's upload
        (or are uploaded alone in lock-step)."""
        host = isinstance(tokens, np.ndarray)
        step = T.prepare_step(self.cfg, state, int(tokens.shape[1]),
                              self.device, active=active, row=row,
                              tokens=tokens if host else None,
                              staging=self.staging)
        if not host:
            return step, tokens
        if step is None:
            return None, torch.as_tensor(tokens, device=self.device)
        return step, step.tokens

    # ------------------------------------------------------------------
    def decode(self, state, tokens, pstate=None, active=None, *,
               collect_info: bool = False):
        """One decode step of B rows: tokens (B, C) ints on the device or
        on the host (a numpy array, uploaded with the step's positions).

        Plain plane: any state (module docstring); returns ``(logits (B,
        C, V), state, None, infos)``, ``infos`` the per-layer routing and
        hidden states on the device with ``collect_info``
        (``transformer.decode_step``), else None.

        Packed planes: ``state`` is dense rings (in lock-step or at
        per-row positions) or paged (``"pages"``), where ``active`` (B,)
        numpy bool marks the rows that go through the expert pool (and,
        paged, write KV and advance ``pos``); the others compute nothing
        that is kept.  The B * C token rows go through one acquire per MoE
        layer (``pstate`` made for at least B * C rows).  Speculative
        staging runs only for a single token (B * C = 1: on the side
        stream on the pipelined plane, inside the layer otherwise).  KV
        and ``pstate`` are updated in place.  Returns ``(logits (B, C,
        V), state, pstate, route_ids)``, ``route_ids`` one (B * C, K) host
        array per MoE layer, token-major (row b's tokens at ``b * C +
        j``)."""
        step, tokens = self._prepare(state, tokens, active)
        if not self.packed:
            out = T.decode_step(self.params, self.cfg, state, tokens,
                                collect_info=collect_info, active=active,
                                step=step)
            return out[0], out[1], None, (out[2] if collect_info else None)
        B, C = tokens.shape
        cfg, spec = self.cfg, self.spec
        rows_dev = step.rows if step is not None else None
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
        return (logits, dict(state, pos=T.advance(state, C, active=active)),
                pstate, route_ids)

    def decode_sampled(self, state, tokens, *, collect_info: bool,
                       greedy: bool, active=None):
        """Plain-plane decode with the sampling input prepared on the
        device: the greedy argmax (B,) int32, or the last-position logits
        (B, V).  Returns ``(next, state)``, and the per-layer infos with
        ``collect_info``."""
        if self.packed:
            raise ValueError("packed decode returns logits; sample on the "
                             "host side")
        logits, state, _, infos = self.decode(state, tokens, active=active,
                                              collect_info=collect_info)
        nxt = (torch.argmax(logits[:, -1], dim=-1).to(torch.int32) if greedy
               else logits[:, -1])
        return (nxt, state, infos) if collect_info else (nxt, state)

    # ------------------------------------------------------------------
    def prefill_chunk(self, state, tokens):
        """Prompt chunk ``tokens`` (B, C) at the current position: KV
        written at ``pos .. pos+C-1``, ``pos`` advances by C.  Returns
        ``(logits (B, C, V), state)``; the pool is not involved."""
        if not self.packed:
            return T.decode_step(self.params, self.cfg, state, tokens)
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
        position (through the ragged binding), MoE runs by the gather
        (plain plane) or store-direct through the prefill tier (packed),
        and only that row's ``pos`` advances.  Returns ``(logits (1, C,
        V), state)``; there is no install step, the running batch reads
        the pools the chunk wrote."""
        if "pages" not in state:
            raise ValueError("prefill_chunk_row needs a paged-KV state")
        step, tokens = self._prepare(state, tokens, row=slot)
        if not self.packed:
            return T.decode_step(self.params, self.cfg, state, tokens,
                                 row=slot, step=step)
        cfg = self.cfg
        C = int(tokens.shape[1])
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
        return logits, dict(state, pos=T.advance(state, C, row=slot))

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

    def prefill_padded(self, batch, max_len: int):
        """Left-padded batched prefill (the static ``ServeEngine``):
        ``batch["tokens"]`` (B, S) and an optional ``batch["pad_mask"]``
        (B, S) bool, host arrays or tensors, through the full-sequence
        training forward with pad isolation (``transformer.prefill``:
        dispatch MoE with capacity, S x S attention), a different program
        from the chunk path.  Plain plane only.  Returns (logits (B, S,
        V), state with per-row ``pos`` when padded)."""
        if self.packed:
            raise ValueError("the packed planes prefill through chunks")
        batch = dict(batch, tokens=torch.as_tensor(batch["tokens"],
                                                   device=self.device))
        return T.make_prefill(self.cfg)(self.params, batch, max_len)

    # ------------------------------------------------------------------
    def generate_greedy(self, prompt, max_new_tokens: int, *,
                        prefill_chunk: Optional[int] = None) -> np.ndarray:
        """Greedy decode of one prompt (1, S) on the plain plane: the
        parity oracle's loop (``generate_plain``).  Returns (1, n) ints."""
        if self.packed:
            raise ValueError("generate_greedy runs the plain plane; the "
                             "offload engine drives the packed planes")
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        max_len = int(prompt.shape[1]) + max_new_tokens
        logits, state = self.prefill(prompt, max_len, chunk=prefill_chunk)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            nxt, state = self.decode_sampled(state, tok, collect_info=False,
                                             greedy=True)
            tok = nxt[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()
