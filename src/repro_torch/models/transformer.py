"""Model assembly of the ported slices: blocks of (SWA or global)
attention + MoE FFN or dense MLP, pre-norm residual.

Port of the reference's ``models/transformer.py`` for the ``swa+moe``,
``attn+moe``, ``swa+mlp`` and ``attn+mlp`` block kinds.  The reference
stacks each pattern position's parameters over periods for ``lax.scan``;
the port keeps one dict per layer, ``params["layers"][l]``, and loops in
Python (``bridge`` un-stacks the reference's layout).  The decode state
is one dense KV ring per layer plus the shared position, or, paged, one
page pool per layer plus a page table and per-row positions kept on the
host (numpy); pools and rings are updated in place.

:func:`decode_step` is the plain plane's step (the reference's
``decode_step(moe_mode="gather")``): dense resident weights, MoE by the
per-token gather.  The packed planes run the same mixer
(:func:`decode_block_packed_mixer`) and their own MoE halves.
:func:`forward_train` is the training forward: full-sequence attention
and the scatter-dispatch MoE, plain PyTorch under autograd, with
optional activation checkpointing per period of the block pattern.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, parse_block
from repro_torch.models import layers as L
from repro_torch.models import moe as M

BLOCK_KINDS = ("swa+moe", "attn+moe", "swa+mlp", "attn+mlp")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port does not run yet (ROADMAP queue 1, item 6)."""
    bad = sorted(set(cfg.layer_kinds()) - set(BLOCK_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (the port "
            f"runs {BLOCK_KINDS})")
    if (cfg.norm != "rmsnorm" or cfg.mlp_act != "swiglu" or cfg.qkv_bias
            or cfg.attn_out_bias or cfg.logit_softcap or cfg.n_tail_layers):
        raise NotImplementedError(
            f"{cfg.name}: only rmsnorm, swiglu, bias-free attention, no "
            f"softcap and no tail layers are ported")


def _init_block(gen, cfg: ModelConfig, kind: str):
    ffn = parse_block(kind)[1]
    return {"norm1": L.init_norm(cfg, gen.device),
            "attn": L.init_attention(gen, cfg),
            "norm2": L.init_norm(cfg, gen.device),
            ffn: M.init_moe(gen, cfg) if ffn == "moe" else L.init_mlp(gen, cfg)}


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {"embed": L.init_embedding(gen, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_lm_head(gen, cfg)
    params["final_norm"] = L.init_norm(cfg, dev)
    params["layers"] = [_init_block(gen, cfg, kind) for kind in cfg.layer_kinds()]
    return params


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The (shape, dtype) of every leaf :func:`init_model` makes, in the
    port's layout, without allocating anything."""
    check_supported(cfg)
    D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    dt = getattr(torch, cfg.dtype)
    leaf = lambda *shape: (tuple(shape), dt)
    norm = {"scale": leaf(D)}

    def block(kind):
        out = {"norm1": norm, "attn": {"wq": leaf(D, H, hd),
                                       "wk": leaf(D, Hkv, hd),
                                       "wv": leaf(D, Hkv, hd),
                                       "wo": leaf(H, hd, D)},
               "norm2": norm}
        if parse_block(kind)[1] == "moe":
            E = cfg.moe.num_experts
            out["moe"] = {"router": ((D, E), torch.float32),
                          "experts": {"w_gate": leaf(E, D, F),
                                      "w_up": leaf(E, D, F),
                                      "w_down": leaf(E, F, D)}}
        else:  # swiglu, the only activation check_supported admits
            out["mlp"] = {"w_gate": leaf(D, F), "w_up": leaf(D, F),
                          "w_down": leaf(F, D)}
        return out

    specs: Dict[str, Any] = {"embed": {"table": leaf(cfg.padded_vocab, D)}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": leaf(D, cfg.padded_vocab)}
    specs["final_norm"] = norm
    specs["layers"] = [block(kind) for kind in cfg.layer_kinds()]
    return specs


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameter count of :func:`init_model` from the shapes alone."""
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return math.prod(t[0])
    return count(param_specs(cfg))


# ----------------------------------------------------------------------
# Training forward
def pad_positions(pad_mask, S: int, device=None):
    """Position layout of a prefill or training batch: with a left-pad
    ``pad_mask`` (B, S), real token j of a row gets logical position j -
    n_pads and pads get -1 (masked out of every attention); without one,
    ``arange(S)``.  Returns (pad_mask as bool or None, positions int32)."""
    if pad_mask is None:
        return None, torch.arange(S, dtype=torch.int32, device=device)
    pad_mask = pad_mask.bool()
    positions = torch.cumsum(pad_mask.to(torch.int32), dim=1,
                             dtype=torch.int32) - 1
    return pad_mask, torch.where(pad_mask, positions,
                                 torch.full_like(positions, -1))


def _block_train(p, cfg: ModelConfig, kind: str, x, positions, pad_mask):
    """One block over the full sequence: (x, load-balance term or None)."""
    h = L.apply_norm(p["norm1"], cfg, x)
    x = x + L.attention_train(p["attn"], cfg, h, positions,
                              window=attention_window(cfg, kind),
                              pad_mask=pad_mask)
    h2 = L.apply_norm(p["norm2"], cfg, x)
    if parse_block(kind)[1] == "mlp":
        return x + L.apply_mlp(p["mlp"], cfg, h2), None
    B, S, D = h2.shape
    y2d, aux = M.moe_apply_dispatch(
        p["moe"], cfg, h2.reshape(B * S, D),
        token_mask=None if pad_mask is None else pad_mask.reshape(B * S))
    return x + y2d.reshape(B, S, D), aux["load_balance"]


def forward_train(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """Teacher-forced logits of ``batch["tokens"]`` (B, S) int tensor (with
    an optional left-pad ``batch["pad_mask"]``).  Returns ``(logits (B,
    S, V) float32, {"load_balance": sum over MoE layers})``.  ``remat``
    recomputes each period's blocks in the backward pass and keeps only
    the residual stream between periods (the reference's
    ``jax.checkpoint`` of its scan body)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    pad_mask, positions = pad_positions(batch.get("pad_mask"), S, x.device)
    kinds = cfg.layer_kinds()
    period = cfg.pattern_period

    def run_period(x, lb, *layer_params):
        for i, lp in enumerate(layer_params):
            x, term = _block_train(lp, cfg, kinds[i], x, positions, pad_mask)
            if term is not None:
                lb = lb + term
        return x, lb

    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, cfg.n_layers, period):
        lps = params["layers"][start: start + period]
        if remat and torch.is_grad_enabled():
            x, lb = torch.utils.checkpoint.checkpoint(
                run_period, x, lb, *lps, use_reentrant=False)
        else:
            x, lb = run_period(x, lb, *lps)
    return apply_head(params, cfg, x), {"load_balance": lb}


# ----------------------------------------------------------------------
def block_decode(p, cfg: ModelConfig, kind: str, x_t, state, pos):
    """One plain block's step over a dense KV ring: the mixer, then the
    MoE by the per-token gather over the dense expert stack, or the
    dense MLP.  Returns (x_t, state, info); info is ``{"route": {ids,
    weights, probs}, "hidden_pre_moe": (B*C, D)}`` for an MoE block, ``{}``
    otherwise (the reference's ``_block_decode(moe_mode="gather")``)."""
    x_t, state, h2 = decode_block_packed_mixer(p, cfg, kind, x_t, state, pos)
    B, S, D = h2.shape
    h2d = h2.reshape(B * S, D)
    if parse_block(kind)[1] == "moe":
        y2d, route = M.moe_apply_gather(p["moe"], cfg, h2d)
        info = {"route": route, "hidden_pre_moe": h2d}
    else:
        y2d, info = L.apply_mlp(p["mlp"], cfg, h2d), {}
    return x_t + y2d.reshape(B, S, D), state, info


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                collect_info: bool = False):
    """The plain plane's step: tokens (B, C) at the rows' shared position
    over dense KV rings (C = 1 decode, C > 1 a prompt chunk, whose
    attention takes the flash binding).  Rings are written in place and
    ``pos`` advances by C.  Returns ``(logits (B, C, V), state)``, and the
    per-layer infos (:func:`block_decode`) with ``collect_info``."""
    if "pages" in state:
        raise NotImplementedError(
            "paged KV on the plain plane comes with ContinuousEngine("
            "offload=None), ROADMAP queue 1 item 3")
    x = embed_tokens(params, cfg, tokens)
    pos = state["pos"]
    infos = []
    for l, kind in enumerate(cfg.layer_kinds()):
        x, state["layers"][l], info = block_decode(
            layer_params(params, cfg, l), cfg, kind, x, state["layers"][l], pos)
        infos.append(info)
    logits = apply_head(params, cfg, x)
    state = dict(state, pos=pos + int(tokens.shape[1]))
    return (logits, state, infos) if collect_info else (logits, state)


def decode_block_packed_mixer(p, cfg: ModelConfig, kind: str, x_t, state,
                              pos, pages=None, active=None, step=None):
    """Mixer half of a block's step (every plane): norm1 + attention +
    residual, plus the pre-MoE norm.  x_t: (B, C, D); the KV ring in
    ``state["kv"]`` is written at ``pos .. pos+C-1``, or with ``pages``
    (or the prepared paged ``step``, ``layers.paged_step``) the page pool
    at each row's own positions, active rows only.  Returns (x_t, state,
    h2 (B, C, D))."""
    h = L.apply_norm(p["norm1"], cfg, x_t)
    window = attention_window(cfg, kind)
    y, kv = L.attention_decode(p["attn"], cfg, h, state["kv"], pos,
                               window=window, pages=pages, active=active,
                               step=step)
    state = dict(state, kv=kv)
    x_t = x_t + y
    return x_t, state, L.apply_norm(p["norm2"], cfg, x_t)


def decode_block_packed_moe(p, cfg: ModelConfig, x_t, h2, store, pstate,
                            l_moe: int, routers=None, *, lookahead: int = 1,
                            n_spec: int = 0, active=None, rows_dev=None,
                            fused: bool = True, vectorized: bool = True,
                            overlap: bool = True):
    """MoE half of a packed block's decode step: route + acquire (+ the
    lookahead layer's staging) + packed compute + residual, over the
    active rows (C = 1); ``fused``/``vectorized``/``overlap`` select the
    plane (``moe.moe_apply_packed``).  Returns (x_t, pstate, info)."""
    B, S, D = h2.shape
    h2d = h2.reshape(B * S, D)
    y2d, route, pstate = M.moe_apply_packed(
        p["moe"], cfg, h2d, store, pstate, l_moe, routers,
        lookahead=lookahead, n_spec=n_spec, active=active, rows_dev=rows_dev,
        fused=fused, vectorized=vectorized, overlap=overlap)
    return (x_t + y2d.reshape(B, S, D), pstate,
            {"route": route, "hidden_pre_moe": h2d})


def prefill_block_packed_moe(p, cfg: ModelConfig, x_t, h2, store, l_moe: int,
                             tier, *, fused: bool = True):
    """MoE half of a prefill chunk: store-direct through the prefill tier."""
    B, C, D = h2.shape
    y2d, route = M.moe_apply_packed_stream(p["moe"], cfg, h2.reshape(B * C, D),
                                           store, l_moe, tier, fused=fused)
    return x_t + y2d.reshape(B, C, D), route


# ----------------------------------------------------------------------
def attention_window(cfg: ModelConfig, kind: str):
    """The sliding window of a block kind's attention (None: global)."""
    return cfg.sliding_window if parse_block(kind)[0] == "swa" else None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device, *, kv_pages: int = None, kv_page: int = None,
                      kv_max_pages: int = None) -> Dict[str, Any]:
    """One dense KV ring per layer (SWA layers ring at the window) and the
    shared start position of the next chunk.

    ``kv_pages``/``kv_page``/``kv_max_pages`` switch to block-paged KV:
    every layer holds a batch-free pool of ``kv_pages`` pages of
    ``kv_page`` positions, and the state grows a page table ``pages``
    ((batch, kv_max_pages), -1 = unallocated) shared by all layers and
    per-row positions ``pos`` (batch,), both numpy on the host, where the
    serving layer keeps them authoritative."""
    check_supported(cfg)
    dev = resolve_device(device)
    if kv_page is not None:
        return {"layers": [{"kv": L.init_paged_attn_cache(cfg, kv_pages,
                                                          kv_page, dev)}
                           for _ in cfg.layer_kinds()],
                "pos": np.zeros((batch,), np.int32),
                "pages": np.full((batch, kv_max_pages), -1, np.int32)}
    rings = [{"kv": L.init_attn_cache(cfg, batch, max_len, dev,
                                      attention_window(cfg, kind))}
             for kind in cfg.layer_kinds()]
    return {"layers": rings, "pos": 0}


def layer_params(params, cfg: ModelConfig, layer_idx: int):
    return params["layers"][layer_idx]


def embed_tokens(params, cfg: ModelConfig, tokens):
    """(B, S) int -> (B, S, D) embeddings."""
    return L.embed(params["embed"], cfg, tokens)


def apply_head(params, cfg: ModelConfig, x):
    """Final norm + unembed."""
    return L.unembed(params, cfg, L.apply_norm(params["final_norm"], cfg, x))
