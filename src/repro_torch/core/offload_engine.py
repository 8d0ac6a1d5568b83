"""The offloaded-inference engine (paper §3.3; port of the reference's
``core/offload_engine.py``).

Batch-1 generation of an MoE model under the paper's algorithm: a
per-layer LRU cache of ``cache_size`` experts, speculative prefetch of
the lookahead layer's likely experts from the current layer's hidden
state, experts at 2-3 bit HQQ and shared weights at ``attn_bits``.  Two
execution modes, as in the reference:

* **packed** (``quantized=True``): experts stay HQQ-packed in a pinned
  host store and stream through a per-layer device pool under the LRU +
  speculative-prefetch machinery (``core/expert_pool``); the expert
  matmuls read the packed records through the dequant-matmul kernels on
  the card (their plain versions on the CPU).  The counters are measured
  copies.  ``fused=``/``pipelined=``/``vectorized=`` select the packed
  plane (:func:`PackedDecoder`).
* **accounting** (``quantized=False``, or ``quantized=True,
  packed=False`` over the eagerly dequantized model): the plain plane
  decodes with dense resident weights and the engine replays each step's
  routing through ``PyLRU``, so offloading is pure scheduling and the
  tokens are those of :func:`generate_plain`.  ``expert_bytes`` comes
  from the cost model's effective bits.

Both modes sample through ``serving/sampler`` and keep the decayed
routing histogram ``usage`` (:class:`ExpertUsageTracker`, which the
serving scheduler's expert-overlap policy also reads).

:meth:`OffloadEngine.throughput_estimate` turns a run's counters
(``OffloadStats.per_token``) into the cost model's tokens/s on a
hardware row (``cost_model.HARDWARE``).

Not ported yet (ROADMAP queue 1): draft-and-verify (item 4) and
telemetry (item 7).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OffloadSpec
from repro_torch.core import cost_model, expert_pool as EP, speculative
from repro_torch.core.lru_cache import PyLRU
from repro_torch.core.trace import moe_positions, stacked_routers
from repro_torch.quant import hqq
from repro_torch.runtime.executor import Executor
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclass
class OffloadStats:
    n_tokens: int = 0
    hits: int = 0
    spec_hits: int = 0
    demand_loads: int = 0
    spec_loads: int = 0
    expert_bytes: float = 0.0  # per expert (quantized)

    @property
    def accesses(self) -> int:
        return self.hits + self.spec_hits + self.demand_loads

    @property
    def hit_ratio(self) -> float:
        return (self.hits + self.spec_hits) / max(1, self.accesses)

    def per_token(self) -> cost_model.TokenStats:
        n = max(1, self.n_tokens)
        return cost_model.TokenStats(
            demand_loads=self.demand_loads / n,
            spec_loads=self.spec_loads / n,
            hits=self.hits / n,
            spec_hits=self.spec_hits / n,
        )

    @property
    def bytes_h2d(self) -> float:
        return (self.demand_loads + self.spec_loads) * self.expert_bytes


# ----------------------------------------------------------------------
def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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
        ids.append(_host(info["route"]["ids"]))
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
_SHARED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
           "w_out")


def quantize_for_offload(params, cfg: ModelConfig, spec: OffloadSpec, *,
                         pack_experts: bool = False, device=None):
    """Mixed quantization (paper §3.3): experts at ``spec.expert_bits``,
    attention and dense-MLP weights at ``spec.attn_bits``; embeddings,
    routers and norms untouched.  Runs on the device the weights are on.

    The reference quantizes its period-stacked parameters, and the port
    keeps its rules on the same stacked view: ``wq``/``wk``/``wv`` as
    (periods, D * H * hd) matrices (so they stay 16-bit unless the period
    count is a multiple of the group size), ``wo`` as one (periods * H *
    hd, D) matrix, dense-MLP weights and experts matrix by matrix; a
    matrix whose K the group size does not divide stays as it is.

    Returns ``(exec_params, size_report)`` with every quantized weight
    dequantized back to dense in the model dtype (the parity oracle of
    the packed mode), or, with ``pack_experts``, ``(exec_params,
    size_report, store)``: the experts go into the packed host store
    (``expert_pool.build_store``, the same quantization) and
    ``exec_params`` holds none.  ``size_report`` has the reference's keys
    and byte counts: ``experts``, ``attn``, ``fp16`` (2 bytes per
    element of every leaf left as it is) and ``total``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    sizes = {"experts": 0, "attn": 0, "fp16": 0}
    store = EP.build_store(params, cfg, spec, dev) if pack_experts else None

    def keep(leaf):
        sizes["fp16"] += leaf.numel() * 2
        return leaf

    def quant(leaf, mat, bits, key):
        if leaf.dim() < 2 or mat.shape[-2] % hqq.PAPER_SCHEMES[bits]["group_size"]:
            return keep(leaf)
        qt = hqq.quantize(mat, bits)
        sizes[key] += hqq.nbytes(qt)
        return hqq.dequantize(qt, dtype).reshape(leaf.shape)

    def shared(name, stacked):
        if name in ("wq", "wk", "wv"):
            mat = stacked.reshape(stacked.shape[0], -1)
        elif name == "wo":
            mat = stacked.reshape(-1, stacked.shape[-1])
        else:
            mat = stacked
        return quant(stacked, mat, spec.attn_bits, "attn")

    def walk(blocks, path=()):
        """The leaves at ``path`` of every block of one pattern position
        (one per period) -> their quantized counterparts."""
        if isinstance(blocks[0], dict):
            out = {k: walk([b[k] for b in blocks], path + (k,))
                   for k in blocks[0]}
            out = {k: v for k, v in out.items() if v is not None}
            return [{k: v[i] for k, v in out.items()}
                    for i in range(len(blocks))] if out else None
        if "experts" in path:
            if pack_experts:
                return None
            return [quant(w, w.reshape(-1, *w.shape[-2:]), spec.expert_bits,
                          "experts") for w in blocks]
        if path[-1] in _SHARED:
            return list(shared(path[-1], torch.stack(blocks)).unbind(0))
        return [keep(w) for w in blocks]

    period = cfg.pattern_period
    layers = [None] * cfg.n_layers
    for i in range(period):
        idx = list(range(i, cfg.n_layers, period))
        for l, lp in zip(idx, walk([params["layers"][l] for l in idx])):
            layers[l] = lp
    exec_params = {k: hqq.tree_map(keep, v) for k, v in params.items()
                   if k != "layers"}
    exec_params["layers"] = layers
    if pack_experts:
        sizes["experts"] = store.nbytes()
    sizes["total"] = sizes["experts"] + sizes["attn"] + sizes["fp16"]
    if pack_experts:
        return exec_params, sizes, store
    return exec_params, sizes


def dense_from_store(params, cfg: ModelConfig, store: EP.Tier, device=None):
    """``params`` (a packed model's ``exec_params``) with every MoE layer's
    experts dequantized from the packed store into dense (E, K, N) stacks
    in the model dtype on ``device``, one layer at a time: the same
    weights as ``quantize_for_offload(pack_experts=False)`` gives, with
    no second quantization pass (the dense oracle of a packed run)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    layers = list(params["layers"])
    for i, l in enumerate(EP.moe_layers(cfg)):
        recs = store.buf[i].to(dev)  # (E, record bytes)
        mats = store.layout.views(recs[None]).slice(0)
        experts = {m: hqq.dequantize(qt, dtype)
                   for m, qt in zip(EP.EXPERT_MATS, mats)}
        del recs, mats
        layers[l] = dict(layers[l], moe=dict(layers[l]["moe"], experts=experts))
    return dict(params, layers=layers)


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
    """One model + offload configuration (module docstring).

    ``quantized=False``: accounting mode over ``params`` as given.
    ``quantized=True``: packed mode; with ``packed=False``, accounting
    mode over the eagerly dequantized model (the packed mode's parity
    oracle).  ``store=`` hands a packed engine an already-quantized model:
    ``params`` are then its ``exec_params`` and ``store`` its packed host
    store (``quantize_for_offload(..., pack_experts=True)``).
    ``fused``/``pipelined``/``vectorized`` select the packed plane
    (:func:`PackedDecoder`)."""

    def __init__(self, params, cfg: ModelConfig,
                 spec: Optional[OffloadSpec] = None, quantized: bool = False,
                 *, packed: Optional[bool] = None, store=None, device=None,
                 fused: bool = True, pipelined: bool = True,
                 vectorized: bool = True):
        assert cfg.moe is not None, "offloading targets MoE architectures"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec or cfg.offload or OffloadSpec()
        self.packed = bool(quantized) if packed is None else bool(packed)
        if self.packed and not quantized:
            raise ValueError("packed execution requires quantized=True "
                             "(the store holds HQQ-packed experts)")
        if store is not None and not self.packed:
            raise ValueError("store= is the packed mode's (quantized=True)")
        self.quantized = bool(quantized)
        self.size_report = None
        if quantized and store is None:
            if self.packed:
                params, self.size_report, store = quantize_for_offload(
                    params, cfg, self.spec, pack_experts=True,
                    device=self.device)
            else:
                params, self.size_report = quantize_for_offload(
                    params, cfg, self.spec, device=self.device)
        self.params = params
        self.store = store
        self.routers = stacked_routers(params, cfg)  # (L_moe, D, E)
        self.n_moe_layers = int(self.routers.shape[0])
        if self.packed:
            self._exec = PackedDecoder(params, cfg, self.spec, store,
                                       fused=fused, pipelined=pipelined,
                                       vectorized=vectorized,
                                       device=self.device)
            # measured: what one demand load / prefetch actually copies
            self.expert_bytes = EP.per_expert_nbytes(store)
        else:
            self._exec = Executor(params, cfg, device=self.device)
            self.expert_bytes = cost_model.expert_bytes(
                cfg, self.spec.expert_bits if quantized else 16)
        self.usage = ExpertUsageTracker(self.n_moe_layers,
                                        cfg.moe.num_experts)
        self._last_pool_state: Optional[EP.PoolState] = None
        self.last_timing: dict = {}

    # ------------------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int, greedy: bool = True,
                 rng: Optional[torch.Generator] = None,
                 sampler: Optional[SamplerConfig] = None, *,
                 prefill_chunk: Optional[int] = None, on_step=None
                 ) -> Tuple[np.ndarray, OffloadStats]:
        """prompt: (1, S) ints.  Returns (generated (1, n), stats).

        Packed engines perform the slot swaps (the stats are measured
        copies); accounting engines replay the routing through ``PyLRU``.
        Sampling goes through ``serving/sampler``: ``greedy=False`` is a
        plain categorical :class:`SamplerConfig`, ``sampler=`` overrides.
        ``rng`` is a ``torch.Generator`` on the engine's device; a
        stochastic sampler without one draws from a generator seeded with
        0, so sampled runs repeat.  ``prefill_chunk`` chunks the prompt's
        prefill.

        ``on_step(logits, route_ids)``, when given, sees the last-position
        logits of every step (prefill first, route_ids None there) and
        the host copies of every decode step's routed ids."""
        sampler = sampler or SamplerConfig(
            kind="greedy" if greedy else "categorical")
        if sampler.kind != "greedy" and rng is None:
            rng = torch.Generator(self.device)
            rng.manual_seed(0)
        dec = self._exec
        pstate = dec.init_pool_state() if self.packed else None
        caches = None if self.packed else [
            PyLRU(self.spec.cache_size, self.spec.num_speculative)
            for _ in range(self.n_moe_layers)]
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        max_len = int(prompt.shape[1]) + max_new_tokens
        self._sync()
        t0 = time.perf_counter()
        pre_logits, state = dec.prefill(prompt, max_len, chunk=prefill_chunk)
        tok = self._next_token(rng, pre_logits, sampler)
        out = [int(tok[0, 0])]
        t1 = time.perf_counter()
        if on_step is not None:
            on_step(pre_logits[:, -1], None)
        for _ in range(max_new_tokens - 1):
            if self.packed:
                logits, state, pstate, route_ids = dec.decode(state, tok,
                                                              pstate)
                self.usage.update(route_ids)
            else:
                logits, state, _, infos = dec.decode(state, tok,
                                                     collect_info=True)
                route_ids = self._account(infos, caches)
            tok = self._next_token(rng, logits, sampler)
            out.append(int(tok[0, 0]))
            if on_step is not None:
                on_step(logits[:, -1], route_ids)
        self._sync()
        t2 = time.perf_counter()
        if self.packed:
            c = pstate.counts
            counts = [int(c[0]), int(c[1]), int(c[2]), int(c[3])]
            self._last_pool_state = pstate
        else:
            counts = [sum(getattr(lru, f) for lru in caches)
                      for f in ("hits", "spec_hits", "demand", "spec_loads")]
        stats = OffloadStats(max_new_tokens - 1, *counts,
                             expert_bytes=self.expert_bytes)
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": max_new_tokens - 1}
        return np.asarray(out)[None], stats

    def throughput_estimate(self, stats: OffloadStats, hw_name: str) -> float:
        """The cost model's batch-1 decode tokens/s for this engine's model
        and offload spec on hardware row ``hw_name`` at the per-token
        counters of ``stats``."""
        hw = cost_model.HARDWARE[hw_name]
        bits = self.spec.expert_bits if self.quantized else 16
        return cost_model.tokens_per_second(self.cfg, hw, stats.per_token(),
                                            bits, self.spec.attn_bits)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _next_token(rng, logits, sampler: SamplerConfig) -> torch.Tensor:
        """One sampler step over the last-position logits -> (B, 1) int32
        on the device (greedy: the argmax, no generator)."""
        return sample(rng, logits[:, -1], sampler)[:, None]

    def _account(self, infos, caches: List[PyLRU]) -> List[np.ndarray]:
        """Replay one decode step's routing through the PyLRU caches,
        position by position, layer by layer, with the lookahead layer's
        predicted experts staged after each layer at C = 1 (the packed
        planes' single-row gate).  The routed ids of every layer and the
        predictions reach the host in one read.  Returns the routed ids
        (one (C, K) array per MoE layer)."""
        spec, L = self.spec, self.n_moe_layers
        moe = [i for i in infos if "route" in i]
        ids = [i["route"]["ids"] for i in moe]
        n_pos = int(ids[0].shape[0])
        preds = []
        if n_pos == 1:
            preds = [speculative.predict_experts(
                self.routers[l + spec.lookahead], moe[l]["hidden_pre_moe"],
                spec.num_speculative)[0]
                for l in range(L - spec.lookahead)]
        flat = _host(torch.cat([t.reshape(-1) for t in ids + preds]))
        K = ids[0].shape[1]
        ids_h = [a.reshape(n_pos, K)
                 for a in np.split(flat[: L * n_pos * K], L)]
        preds_h = np.split(flat[L * n_pos * K:], max(1, len(preds)))
        self.usage.update(ids_h)
        for t in range(n_pos):
            for l in range(L):
                caches[l].access(ids_h[l][t])
                if preds and l + spec.lookahead < L:
                    caches[l + spec.lookahead].stage(preds_h[l])
        return ids_h


# ----------------------------------------------------------------------
def generate_plain(params, cfg: ModelConfig, prompt, max_new_tokens: int, *,
                   prefill_chunk: Optional[int] = None,
                   device=None) -> np.ndarray:
    """Greedy decode with no offload bookkeeping (the parity oracle), on
    the plain plane: dense resident weights, MoE by the per-token gather,
    each prompt chunk's attention through the flash binding.  Runs on the
    card unless ``device="cpu"``.  Returns (1, n) ints."""
    return Executor(params, cfg, device=device).generate_greedy(
        prompt, max_new_tokens, prefill_chunk=prefill_chunk)
