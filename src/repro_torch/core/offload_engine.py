"""The offloaded-inference engine (paper §3.3), packed mode.

Port of the reference's ``core/offload_engine.py`` for batch-1 greedy
generation: experts stay HQQ-packed in a pinned host store and stream
through a per-layer device pool of ``cache_size`` slots under the LRU +
speculative-prefetch machinery (``core/expert_pool``); attention weights
are quantized at ``attn_bits`` and dequantized back to dense; router,
norms and embeddings are untouched.  Expert matmuls run through the
Hopper dequant-matmul kernel on the card and its plain PyTorch version on
the CPU.

:class:`ExpertUsageTracker` (with :func:`routing_from_info`) keeps the
decayed histogram of the experts a running batch routes to, which the
serving scheduler's expert-overlap policy reads.

``OffloadEngine(..., fused=, pipelined=, vectorized=)`` selects the
packed plane as the reference does (:func:`PackedDecoder`): pipelined
staging on a side stream or staging inside the block, the vectorized or
the sequential baseline data plane, fused kernels or dequantize-and-einsum.

Not ported yet (ROADMAP queue 1): accounting mode (``quantized=False``),
``generate_plain`` and the plain plane, samplers other than greedy in
``generate``, draft-and-verify, telemetry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OffloadSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.trace import moe_positions
from repro_torch.quant import hqq
from repro_torch.runtime.executor import Executor


@dataclass
class OffloadStats:
    n_tokens: int = 0
    hits: int = 0
    spec_hits: int = 0
    demand_loads: int = 0
    spec_loads: int = 0
    expert_bytes: float = 0.0  # per expert (quantized)

    @property
    def bytes_h2d(self) -> float:
        return (self.demand_loads + self.spec_loads) * self.expert_bytes


# ----------------------------------------------------------------------
def routing_from_info(cfg: ModelConfig, infos, want_hiddens=True):
    """Per-MoE-layer routing of one decode step from the port's per-layer
    infos (one dict per layer, ``{"route": {"ids"}, "hidden_pre_moe"}``
    for MoE layers; the reference unpacks its scan-stacked info the same
    way): returns (ids, hiddens) lists in layer order, arrays (B, top_k)
    int32 and (B, D) (``hiddens`` empty with ``want_hiddens=False``)."""
    ids, hiddens = [], []
    for info in infos[: cfg.n_layers]:
        if "route" not in info:
            continue
        ids.append(np.asarray(info["route"]["ids"]))
        if want_hiddens:
            hiddens.append(info["hidden_pre_moe"].float().cpu().numpy())
    return ids, hiddens


class ExpertUsageTracker:
    """Decayed per-MoE-layer histogram of expert activations: what the
    running batch has recently routed to, i.e. what the offload pools are
    hot with.  The expert-overlap admission policy scores waiting requests
    by their overlap with it (MoBiLE-style expert-aware grouping)."""

    def __init__(self, n_layers: int, n_experts: int, decay: float = 0.9):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.decay = decay
        self.counts = np.zeros((n_layers, n_experts), np.float64)

    @classmethod
    def for_config(cls, cfg: ModelConfig, decay: float = 0.9
                   ) -> "ExpertUsageTracker":
        n = len(moe_positions(cfg)) * cfg.n_periods
        return cls(n, cfg.moe.num_experts, decay)

    def update(self, ids_per_layer, rows=None) -> None:
        """ids_per_layer: list of (B, K) int32; ``rows`` restricts the
        accounting to the active batch rows."""
        self.counts *= self.decay
        for l, ids in enumerate(ids_per_layer):
            sel = ids if rows is None else ids[np.asarray(rows, np.int64)]
            np.add.at(self.counts[l], np.asarray(sel).ravel(), 1.0)

    def normalized(self) -> np.ndarray:
        """(L, E) rows summing to 1 (uniform where a layer has no counts)."""
        tot = self.counts.sum(-1, keepdims=True)
        uniform = np.full_like(self.counts, 1.0 / self.n_experts)
        return np.where(tot > 0, self.counts / np.maximum(tot, 1e-9), uniform)

    def overlap(self, pred_ids_per_layer) -> float:
        """Expected fraction of a candidate's predicted expert hits that
        are already hot, averaged over the layers actually scored."""
        hist = self.normalized()
        score = 0.0
        scored = pred_ids_per_layer[: self.n_layers]
        for l, ids in enumerate(scored):
            score += float(hist[l, np.asarray(ids, np.int64).ravel()].sum())
        return score / max(1, len(scored))


# ----------------------------------------------------------------------
def _quant_dense(w: torch.Tensor, bits: int, mat: torch.Tensor) -> torch.Tensor:
    """Quantize ``mat`` (a 2-D view of ``w``) and dequantize it back to
    ``w``'s shape and dtype; leaves not divisible by the group stay."""
    gs = hqq.PAPER_SCHEMES[bits]["group_size"]
    if mat.shape[-2] % gs:
        return w
    return hqq.dequantize(hqq.quantize(mat, bits), w.dtype).reshape(w.shape)


def quantize_for_offload(params, cfg: ModelConfig, spec: OffloadSpec, *,
                         device=None):
    """Mixed quantization (paper §3.3): experts packed at
    ``spec.expert_bits`` into the host store, attention quantized at
    ``spec.attn_bits`` and dequantized back to dense (the reference's
    parity-oracle treatment of shared weights); router, norms and
    embeddings untouched.  Runs on the device the weights are on.

    Returns ``(exec_params, store)``; ``exec_params`` holds no expert
    weights (the engine computes MoE from the store)."""
    dev = resolve_device(device)
    store = EP.build_store(params, cfg, spec, dev)
    layers = []
    for lp in params["layers"]:
        attn = {}
        for name, w in lp["attn"].items():
            if name in ("wq", "wk", "wv"):
                attn[name] = _quant_dense(w, spec.attn_bits,
                                          w.reshape(w.shape[0], -1))
            elif name == "wo":
                attn[name] = _quant_dense(w, spec.attn_bits,
                                          w.reshape(-1, w.shape[-1]))
            else:
                attn[name] = w
        moe = {"router": lp["moe"]["router"]}
        layers.append({"norm1": lp["norm1"], "attn": attn,
                       "norm2": lp["norm2"], "moe": moe})
    exec_params = {k: v for k, v in params.items() if k != "layers"}
    exec_params["layers"] = layers
    return exec_params, store


# ----------------------------------------------------------------------
def PackedDecoder(params, cfg: ModelConfig, spec: OffloadSpec, store, *,
                  fused: bool = True, pipelined: bool = True,
                  vectorized: bool = True, device=None) -> Executor:
    """The packed-plane executor for the reference's flags:
    ``pipelined`` picks ``packed_pipelined`` over ``packed_vectorized``."""
    plane = "packed_pipelined" if pipelined else "packed_vectorized"
    return Executor(params, cfg, spec=spec, store=store, device=device,
                    plane=plane, fused=fused, vectorized=vectorized)


# ----------------------------------------------------------------------
class OffloadEngine:
    """One model + offload configuration: the reference's
    ``OffloadEngine(quantized=True)`` (packed mode; accounting mode is not
    ported yet, ROADMAP queue 1 item 6).

    ``params`` are either raw weights (the engine quantizes them itself)
    or, with ``store=``, the ``exec_params`` of an already-quantized model
    and its packed store.  ``fused``/``pipelined``/``vectorized`` select
    the packed plane (:func:`PackedDecoder`).
    """

    def __init__(self, params, cfg: ModelConfig,
                 spec: Optional[OffloadSpec] = None, *, store=None,
                 device=None, fused: bool = True, pipelined: bool = True,
                 vectorized: bool = True):
        assert cfg.moe is not None, "offloading targets MoE architectures"
        self.cfg = cfg
        self.spec = spec or cfg.offload or OffloadSpec()
        self.device = resolve_device(device)
        if store is None:
            params, store = quantize_for_offload(params, cfg, self.spec,
                                                 device=self.device)
        self.params = params
        self.store = store
        self._exec = PackedDecoder(params, cfg, self.spec, store,
                                   fused=fused, pipelined=pipelined,
                                   vectorized=vectorized, device=self.device)
        self.n_moe_layers = self._exec.n_moe_layers
        self.expert_bytes = EP.per_expert_nbytes(store)
        self._last_pool_state: Optional[EP.PoolState] = None
        self.last_timing: dict = {}

    # ------------------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int, *,
                 prefill_chunk: Optional[int] = None, on_step=None
                 ) -> Tuple[np.ndarray, OffloadStats]:
        """Greedy generation (other samplers are not ported yet).  prompt:
        (1, S) ints.  Returns (generated (1, n), stats).

        ``on_step(logits, route_ids)``, when given, sees the last-position
        logits of every step (prefill first, route_ids None there) and
        the host copies of every decode step's routed ids."""
        return self._generate_packed(prompt, max_new_tokens,
                                     prefill_chunk=prefill_chunk,
                                     on_step=on_step)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generate_packed(self, prompt, max_new_tokens: int, *,
                         prefill_chunk: Optional[int] = None, on_step=None):
        """Prefill streams the routed experts store-direct; every decode
        token is served from the device pool with real slot swaps and
        speculative staging (``Executor.decode``)."""
        dec = self._exec
        pstate = dec.init_pool_state()
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        max_len = int(prompt.shape[1]) + max_new_tokens
        self._sync()
        t0 = time.perf_counter()
        pre_logits, state = dec.prefill(prompt, max_len, chunk=prefill_chunk)
        tok = torch.argmax(pre_logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [int(tok[0, 0])]
        t1 = time.perf_counter()
        if on_step is not None:
            on_step(pre_logits[:, -1], None)
        for _ in range(max_new_tokens - 1):
            logits, state, pstate, route_ids = dec.decode(state, tok, pstate)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
            if on_step is not None:
                on_step(logits[:, -1], route_ids)
        self._sync()
        t2 = time.perf_counter()
        c = pstate.counts
        stats = OffloadStats(
            n_tokens=max_new_tokens - 1, hits=int(c[0]), spec_hits=int(c[1]),
            demand_loads=int(c[2]), spec_loads=int(c[3]),
            expert_bytes=self.expert_bytes)
        self._last_pool_state = pstate
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": max_new_tokens - 1}
        return np.asarray(out)[None], stats
