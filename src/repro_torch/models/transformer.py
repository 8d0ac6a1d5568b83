"""Model assembly of the ported slices: blocks of (SWA or global)
attention + MoE FFN or dense MLP, pre-norm residual.

Port of the reference's ``models/transformer.py`` for the ``swa+moe``,
``attn+moe``, ``swa+mlp`` and ``attn+mlp`` block kinds.  The reference
stacks each pattern position's parameters over periods for ``lax.scan``;
the port keeps one dict per layer, ``params["layers"][l]``, and loops in
Python (``bridge`` un-stacks the reference's layout).  The decode state
is one dense KV ring per layer plus the shared position (an int) or
per-row positions (a host (B,) array), or, paged, one page pool per
layer plus a page table and per-row positions kept on the host (numpy);
pools and rings are updated in place, positions never read back.

:func:`decode_step` is the plain plane's step (the reference's
``decode_step(moe_mode="gather")``): dense resident weights, MoE by the
per-token gather, on dense or paged states.  The packed planes run the
same mixer (:func:`decode_block_packed_mixer`) and their own MoE halves.
:func:`forward_train` is the training forward: full-sequence attention
and the scatter-dispatch MoE, plain PyTorch under autograd, with
optional activation checkpointing per period of the block pattern; with
``want_state`` it is also the static engine's prefill (:func:`prefill`).
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


def _attn_train_with_cache(p, cfg: ModelConfig, h, positions, window,
                           max_len: int, pad_mask=None):
    """Full-sequence attention that also fills the layer's decode KV ring
    (``max_len`` wide, the window's width on SWA layers): the last
    ``min(W, S)`` positions' K/V land at ``position mod W``.  With a
    left-pad ``pad_mask`` the pads carry position -1 and land in slot
    W - 1, which a row's real entries never occupy while they are fewer
    than W (and when they are not, no pad is in the tail), so decode
    skips them by the position mask.  Returns (y, ring)."""
    B, S, _ = h.shape
    y = L.attention_train(p, cfg, h, positions, window=window,
                          pad_mask=pad_mask)
    cache = L.init_attn_cache(cfg, B, max_len, h.device, window)
    W = cache["k"].shape[1]
    k_full, v_full = L._project_kv(p, cfg, h)
    k_full = L.apply_rope(k_full, positions, cfg)
    n = min(W, S)
    tail_pos = positions.expand(B, S)[:, -n:]
    if pad_mask is not None:
        tail_pos = torch.where(pad_mask[:, -n:], tail_pos,
                               torch.full_like(tail_pos, -1))
    slots = torch.remainder(tail_pos, W).long()
    bidx = torch.arange(B, device=h.device)[:, None]
    cache["k"][bidx, slots] = k_full[:, -n:]
    cache["v"][bidx, slots] = v_full[:, -n:]
    cache["pos"][bidx, slots] = tail_pos.to(torch.int32)
    return y, cache


def _block_train(p, cfg: ModelConfig, kind: str, x, positions, pad_mask,
                 max_len=None):
    """One block over the full sequence: (x, load-balance term or None,
    the layer's decode state when ``max_len`` asks for one, else None)."""
    h = L.apply_norm(p["norm1"], cfg, x)
    window = attention_window(cfg, kind)
    st = None
    if max_len is None:
        y = L.attention_train(p["attn"], cfg, h, positions, window=window,
                              pad_mask=pad_mask)
    else:
        y, kv = _attn_train_with_cache(p["attn"], cfg, h, positions, window,
                                       max_len, pad_mask)
        st = {"kv": kv}
    x = x + y
    h2 = L.apply_norm(p["norm2"], cfg, x)
    if parse_block(kind)[1] == "mlp":
        return x + L.apply_mlp(p["mlp"], cfg, h2), None, st
    B, S, D = h2.shape
    y2d, aux = M.moe_apply_dispatch(
        p["moe"], cfg, h2.reshape(B * S, D),
        token_mask=None if pad_mask is None else pad_mask.reshape(B * S))
    return x + y2d.reshape(B, S, D), aux["load_balance"], st


def forward_train(params, cfg: ModelConfig, batch, *, remat: bool = False,
                  want_state: bool = False, max_len: int = 0):
    """Teacher-forced logits of ``batch["tokens"]`` (B, S) int tensor (with
    an optional left-pad ``batch["pad_mask"]``, a tensor or a host bool
    array).  Returns ``(logits (B, S, V) float32, {"load_balance": sum
    over MoE layers})``.  ``remat`` recomputes each period's blocks in the
    backward pass and keeps only the residual stream between periods (the
    reference's ``jax.checkpoint`` of its scan body).

    ``want_state`` also returns the decode state the prompt leaves (the
    static engine's prefill): every layer's KV ring of ``max_len``
    (default S) positions (:func:`_attn_train_with_cache`), and ``pos``,
    S for every row, or with a pad mask each row's real-token count as a
    host (B,) array: the per-row positions decode continues from."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    mask = mask_host = batch.get("pad_mask")
    if isinstance(mask, np.ndarray):
        mask = torch.as_tensor(mask, device=x.device)
    elif mask is not None and want_state:
        mask_host = mask.cpu().numpy()  # the per-row positions live on the host
    pad_mask, positions = pad_positions(mask, S, x.device)
    kinds = cfg.layer_kinds()
    period = cfg.pattern_period
    ring_len = (max_len or S) if want_state else None
    states = []

    def run_period(x, lb, *layer_params):
        for i, lp in enumerate(layer_params):
            x, term, st = _block_train(lp, cfg, kinds[i], x, positions,
                                       pad_mask, ring_len)
            if term is not None:
                lb = lb + term
            if want_state:
                states.append(st)
        return x, lb

    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, cfg.n_layers, period):
        lps = params["layers"][start: start + period]
        if remat and torch.is_grad_enabled() and not want_state:
            x, lb = torch.utils.checkpoint.checkpoint(
                run_period, x, lb, *lps, use_reentrant=False)
        else:
            x, lb = run_period(x, lb, *lps)
    logits, aux = apply_head(params, cfg, x), {"load_balance": lb}
    if not want_state:
        return logits, aux
    pos = (S if pad_mask is None
           else mask_host.astype(bool).sum(1).astype(np.int32))
    return logits, aux, {"layers": states, "pos": pos}


def prefill(params, cfg: ModelConfig, batch, max_len: int):
    """The static engine's prefill: :func:`forward_train` with the decode
    state (``batch`` may carry a left-pad ``pad_mask``; the state's
    ``pos`` is then per row).  Returns (logits, state)."""
    logits, _, state = forward_train(params, cfg, batch, want_state=True,
                                     max_len=max_len)
    return logits, state


def make_prefill(cfg: ModelConfig):
    """``fn(params, batch, max_len)``: :func:`prefill` for ``cfg`` (the
    reference's shared jitted wrapper; nothing is compiled here)."""
    return lambda params, batch, max_len: prefill(params, cfg, batch,
                                                  max_len)


# ----------------------------------------------------------------------
def block_decode(p, cfg: ModelConfig, kind: str, x_t, state, pos, step=None):
    """One plain block's step: the mixer (over a dense KV ring, or the
    prepared per-row or paged ``step``), then the MoE by the per-token
    gather over the dense expert stack, or the dense MLP.  Returns (x_t,
    state, info); info is ``{"route": {ids, weights, probs},
    "hidden_pre_moe": (B*C, D)}`` for an MoE block, ``{}`` otherwise (the
    reference's ``_block_decode(moe_mode="gather")``)."""
    x_t, state, h2 = decode_block_packed_mixer(p, cfg, kind, x_t, state, pos,
                                               step=step)
    B, S, D = h2.shape
    h2d = h2.reshape(B * S, D)
    if parse_block(kind)[1] == "moe":
        y2d, route = M.moe_apply_gather(p["moe"], cfg, h2d)
        info = {"route": route, "hidden_pre_moe": h2d}
    else:
        y2d, info = L.apply_mlp(p["mlp"], cfg, h2d), {}
    return x_t + y2d.reshape(B, S, D), state, info


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                collect_info: bool = False, active=None, row=None,
                step=None):
    """The plain plane's step: tokens (B, C) at each row's position (C = 1
    decode, C > 1 a prompt chunk, whose attention over an unwrapped dense
    ring takes the flash binding).  KV is written in place.  Returns
    ``(logits (B, C, V), state)``, and the per-layer infos
    (:func:`block_decode`) with ``collect_info``.

    * Dense rings, ``pos`` an int: the rows in lock-step; ``pos``
      advances by C.
    * Dense rings, ``pos`` a host (B,) array (continuous batching, a
      left-padded batch): one token per row at its own position; every
      row computes, writes its own ring row and advances (``active`` is
      not needed: a free slot's writes stay in its row).
    * Paged states (``"pages"``): ``active`` (B,) bool gates which rows
      write KV and advance (the others advance 0), and ``row=slot`` runs
      tokens (1, C) as that row's chunk against the shared page pools,
      through the ragged binding, advancing only that row.

    ``step`` is the step's prepared :func:`prepare_step` (built here when
    not given)."""
    if row is not None and "pages" not in state:
        raise ValueError("row chunks need a paged-KV state")
    C = int(tokens.shape[1])
    if step is None:
        step = prepare_step(cfg, state, C, tokens.device, active=active,
                            row=row)
    x = embed_tokens(params, cfg, tokens)
    pos = state["pos"]
    infos = []
    for l, kind in enumerate(cfg.layer_kinds()):
        x, state["layers"][l], info = block_decode(
            layer_params(params, cfg, l), cfg, kind, x, state["layers"][l],
            pos, step)
        infos.append(info)
    logits = apply_head(params, cfg, x)
    state = dict(state, pos=advance(state, C, active=active, row=row))
    return (logits, state, infos) if collect_info else (logits, state)


def attention_windows(cfg: ModelConfig):
    """The distinct attention windows of the stack, in layer order (one
    ragged work list each)."""
    return tuple(dict.fromkeys(attention_window(cfg, k)
                               for k in cfg.layer_kinds()))


def prepare_step(cfg: ModelConfig, state, C: int, device, *, active=None,
                 row=None, tokens=None, staging=None):
    """What every attention layer of one step needs, built on the host
    from the state's host positions and uploaded in one copy with the
    step's host ``tokens`` (when given): a ``layers.PagedStep`` on a paged
    state (over row ``row`` alone for a row chunk), a ``layers.RingStep``
    on dense rings at per-row positions, None in lock-step."""
    pos = state["pos"]
    if "pages" in state:
        rows = slice(None) if row is None else slice(row, row + 1)
        return L.paged_step(pos[rows], state["pages"][rows],
                            None if row is not None else active, C,
                            state["layers"][0]["kv"]["ppos"].shape[1],
                            device, attention_windows(cfg), staging,
                            tokens=tokens)
    if isinstance(pos, np.ndarray):
        return L.ring_step(pos, C, device, staging, active=active,
                           tokens=tokens)
    return None


def advance(state, C: int, *, active=None, row=None):
    """The state's positions after a step of C tokens: a row chunk
    advances its row; on pages, inactive rows advance 0; otherwise every
    row advances C."""
    pos = state["pos"]
    if row is not None:
        pos = pos.copy()
        pos[row] += C
        return pos
    if "pages" in state and active is not None:
        return (pos + np.where(active, C, 0)).astype(np.int32)
    if isinstance(pos, np.ndarray):
        return (pos + C).astype(np.int32)
    return pos + C


def decode_block_packed_mixer(p, cfg: ModelConfig, kind: str, x_t, state,
                              pos, pages=None, active=None, step=None):
    """Mixer half of a block's step (every plane): norm1 + attention +
    residual, plus the pre-MoE norm.  x_t: (B, C, D); the KV ring in
    ``state["kv"]`` is written at ``pos .. pos+C-1``, at each row's own
    position with a ``layers.RingStep``, or with ``pages`` (or a prepared
    ``layers.PagedStep``) the page pool at each row's own positions,
    active rows only.  Returns (x_t, state, h2 (B, C, D))."""
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
