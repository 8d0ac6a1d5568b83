"""Model assembly of the ported slices: blocks of a mixer ((SWA or
global) attention, self-attention plus cross-attention over an encoder
(``xattn``), or the recurrent RG-LRU / mLSTM / sLSTM of
``models/recurrent``) + MoE FFN, dense MLP or no FFN, pre-norm residual.

Port of the reference's ``models/transformer.py`` for every block kind
(rmsnorm or layernorm, swiglu / geglu / gelu, optional attention biases,
logit softcap, the image-token stub, the encoder-decoder).  The
reference stacks each pattern position's parameters over periods for
``lax.scan`` and keeps the layers past the last whole period (tail
layers) apart; the port keeps one dict per layer, ``params["layers"][l]``,
tail included, and loops in Python (``bridge`` un-stacks the reference's
layout).  The decode state is one dense KV ring per attention layer plus
the shared position (an int) or per-row positions (a host (B,) array),
or, paged, one page pool per attention layer plus a page table and
per-row positions kept on the host (numpy); pools and rings are updated
in place, positions never read back.  A recurrent layer's state (``{"rec": ...}``, the reference's "rec"
plane) is fixed-size and dense, one row per batch row, paged config or
not; a step replaces it, except where a row chunk writes its row in
place, and rows outside ``active`` keep theirs bit for bit.

An encoder-decoder (whisper) has ``params["encoder"]``: a stack of
bidirectional ``encattn+mlp`` blocks (self-attention with RoPE, no mask)
and a final norm, run once per request over its frontend embeddings
(``audio_embeds`` (B, S_e, D)).  Each decoder layer's cross-attention K/V
of the encoder's output form the shared encoder-KV plane,
``state["enc_kv"]`` = {"k", "v": (n_layers, B, S_e, Hkv, hd)}, batch-indexed
like the rings and never paged: written whole at admission
(:func:`encode_enc_kv`), only read after.  Every key of it is valid, so
cross-attention is non-causal over all S_e frames (``layers.attend_all``).

:func:`decode_step` is the plain plane's step (the reference's
``decode_step(moe_mode="gather")``): dense resident weights, MoE by the
per-token gather, on dense or paged states.  The packed planes run the
same mixer (:func:`decode_block_packed_mixer`) and their own MoE halves.
:func:`forward_train` is the training forward: full-sequence attention
(or the recurrent mixers' training forms) and the scatter-dispatch MoE,
plain PyTorch under autograd, with optional activation checkpointing per
period of the block pattern (the tail layers outside it); with
``want_state`` it is also the static engine's prefill (:func:`prefill`).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import MIXER_STATE, ModelConfig, parse_block
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.sharding import specs as SP
from repro_torch.sharding.specs import constrain, is_dtensor

ATTN_MIXERS = ("attn", "swa", "xattn")  # self-attention over a ring or pages
REC_MIXERS = ("rglru", "mlstm", "slstm")
NORMS = ("rmsnorm", "layernorm")
MLP_ACTS = ("swiglu", "geglu", "gelu")
ENCODER_KIND = "encattn+mlp"  # every block of an encoder-decoder's encoder


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a stack the port does not run: a decoder mixer outside
    ``ATTN_MIXERS + REC_MIXERS``, or an encoder whose decoder is not all
    ``xattn`` (and ``xattn`` without an encoder), as the reference reads
    every decoder layer's cross K/V from the encoder."""
    mixers = {parse_block(k)[0] for k in cfg.layer_kinds()}
    bad = sorted(mixers - set(ATTN_MIXERS) - set(REC_MIXERS))
    enc_dec = mixers == {"xattn"} if cfg.is_encoder_decoder \
        else "xattn" not in mixers
    if bad or not enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: mixers {sorted(mixers)} with {cfg.encoder_layers} "
            f"encoder layers (the port runs {ATTN_MIXERS + REC_MIXERS}, "
            f"xattn exactly when there is an encoder)")
    if cfg.norm not in NORMS or cfg.mlp_act not in MLP_ACTS:
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r} or activation {cfg.mlp_act!r} "
            f"(the port runs {NORMS} and {MLP_ACTS})")


def _init_block(gen, cfg: ModelConfig, kind: str):
    """A block's parameters: ``norm1`` and the mixer's (``attn``, or the
    recurrent mixer's name; ``xattn`` adds ``norm_x`` and the
    cross-attention's ``xattn``), then ``norm2`` and the FFN's unless the
    block has none (the reference's ``_init_block``)."""
    mixer, ffn = parse_block(kind)
    p = {"norm1": L.init_norm(cfg, gen.device)}
    if mixer in REC_MIXERS:
        p[mixer] = R.INIT[mixer](gen, cfg)
    else:
        p["attn"] = L.init_attention(gen, cfg)
    if mixer == "xattn":
        p["norm_x"] = L.init_norm(cfg, gen.device)
        p["xattn"] = L.init_attention(gen, cfg)
    if ffn != "none":
        p["norm2"] = L.init_norm(cfg, gen.device)
        p[ffn] = M.init_moe(gen, cfg) if ffn == "moe" else L.init_mlp(gen, cfg)
    return p


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               on_block=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``).  ``on_block(l, block)``, when given,
    sees each layer's block as soon as it is drawn and returns what to
    keep of it (``offload_engine.init_packed_model`` packs the experts
    away one layer at a time)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {"embed": L.init_embedding(gen, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_lm_head(gen, cfg)
    params["final_norm"] = L.init_norm(cfg, dev)
    params["layers"] = []
    for l, kind in enumerate(cfg.layer_kinds()):
        blk = _init_block(gen, cfg, kind)
        params["layers"].append(blk if on_block is None else on_block(l, blk))
    if cfg.is_encoder_decoder:
        # the reference's encoder config: its depth sets the init scales
        enc_cfg = cfg.replace(block_pattern=(ENCODER_KIND,),
                              n_layers=cfg.encoder_layers)
        params["encoder"] = {
            "layers": [_init_block(gen, enc_cfg, ENCODER_KIND)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.init_norm(cfg, dev)}
    if cfg.num_image_tokens:
        D = cfg.d_model
        params["img_proj"] = L._randn(gen, (D, D), D ** -0.5, L._dt(cfg))
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
    if cfg.norm == "layernorm":
        norm["bias"] = leaf(D)
    attn = {"wq": leaf(D, H, hd), "wk": leaf(D, Hkv, hd),
            "wv": leaf(D, Hkv, hd), "wo": leaf(H, hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=leaf(H, hd), bk=leaf(Hkv, hd), bv=leaf(Hkv, hd))
    if cfg.attn_out_bias:
        attn["bo"] = leaf(D)

    f32 = lambda *shape: (tuple(shape), torch.float32)
    dh = D // H
    rec = {
        "rglru": {"w_x": leaf(D, D), "w_gate_br": leaf(D, D),
                  "conv_w": leaf(cfg.rglru_conv_width, D), "conv_b": leaf(D),
                  "w_rec_gate": leaf(D, D), "w_in_gate": leaf(D, D),
                  "lam": f32(D), "w_out_r": leaf(D, D)},
        "mlstm": {"wq": leaf(D, H, dh), "wk": leaf(D, H, dh),
                  "wv": leaf(D, H, dh), "wf": f32(D, H), "bf": f32(H),
                  "wi": f32(D, H), "bi": f32(H), "w_ogate": leaf(D, D),
                  "headnorm": f32(H, dh), "out_proj": leaf(D, D)},
        "slstm": {"w_gates_in": leaf(D, R.N_SGATES, H, dh),
                  "r_gates": leaf(R.N_SGATES, H, dh, dh),
                  "b_gates": f32(R.N_SGATES, H, dh), "headnorm": f32(H, dh),
                  "out_proj": leaf(D, D)},
    }

    def block(kind):
        mixer, ffn = parse_block(kind)
        out = {"norm1": norm}
        if mixer in REC_MIXERS:
            out[mixer] = rec[mixer]
        else:
            out["attn"] = attn
        if mixer == "xattn":
            out.update(norm_x=norm, xattn=attn)
        if ffn == "none":
            return out
        out["norm2"] = norm
        if ffn == "moe":
            E = cfg.moe.num_experts
            out["moe"] = {"router": ((D, E), torch.float32),
                          "experts": {"w_gate": leaf(E, D, F),
                                      "w_up": leaf(E, D, F),
                                      "w_down": leaf(E, F, D)}}
        elif cfg.mlp_act in ("swiglu", "geglu"):
            out["mlp"] = {"w_gate": leaf(D, F), "w_up": leaf(D, F),
                          "w_down": leaf(F, D)}
        else:
            out["mlp"] = {"w_in": leaf(D, F), "w_out": leaf(F, D)}
        return out

    specs: Dict[str, Any] = {"embed": {"table": leaf(cfg.padded_vocab, D)}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": leaf(D, cfg.padded_vocab)}
    specs["final_norm"] = norm
    specs["layers"] = [block(kind) for kind in cfg.layer_kinds()]
    if cfg.is_encoder_decoder:
        specs["encoder"] = {"layers": [block(ENCODER_KIND)] * cfg.encoder_layers,
                            "final_norm": norm}
    if cfg.num_image_tokens:
        specs["img_proj"] = leaf(D, D)
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
    cache = _init_ring(cfg, B, max_len, h, window)
    W = cache["k"].shape[1]
    k_full, v_full = L._project_kv(p, cfg, h)
    k_full = L.apply_rope(k_full, positions, cfg)
    n = min(W, S)
    tail_pos = positions.expand(B, S)[:, -n:]
    if pad_mask is not None:
        tail_pos = torch.where(pad_mask[:, -n:], tail_pos,
                               torch.full_like(tail_pos, -1))
    slots = torch.remainder(tail_pos, W).long()
    L.ring_write(cache["k"], slots, k_full[:, -n:])
    L.ring_write(cache["v"], slots, v_full[:, -n:])
    L.ring_write(cache["pos"], slots, tail_pos.to(torch.int32))
    return y, cache


def _init_ring(cfg: ModelConfig, B: int, max_len: int, like, window):
    """``layers.init_attn_cache`` beside activations ``like``; on a mesh
    (``like`` a DTensor) each rank allocates only its shard of the ring,
    split by the decode-state rules (``sharding.specs``)."""
    if not is_dtensor(like):
        return L.init_attn_cache(cfg, B, max_len, like.device, window)
    mesh = like.device_mesh
    W = min(max_len, window) if window else max_len
    dt = L._dt(cfg)
    leaves = {"k": ((B, W, cfg.n_kv_heads, cfg.head_dim), dt, 0),
              "v": ((B, W, cfg.n_kv_heads, cfg.head_dim), dt, 0),
              "pos": ((B, W), torch.int32, -1)}
    specs = SP.decode_state_spec_tree(
        cfg, mesh, B, {"kv": {k: v[:2] for k, v in leaves.items()}})["kv"]
    dev = like.to_local().device
    return {k: SP.sharded_full(mesh, shape, specs[k], fill, dtype, dev)
            for k, (shape, dtype, fill) in leaves.items()}


def _block_train(p, cfg: ModelConfig, kind: str, x, positions, pad_mask,
                 max_len=None, enc_out=None):
    """One block over the full sequence: (x, load-balance term or None,
    the layer's decode state when ``max_len`` asks for one, else None).
    A recurrent mixer runs its training form (pads are not masked out of
    it: callers do not left-pad a recurrent stack) and its state is its
    final carry.  ``encattn`` (an encoder block) attends both ways with
    no state; ``xattn`` is causal self-attention (with its ring when
    asked), then ``norm_x`` and cross-attention over ``enc_out``."""
    mixer, ffn = parse_block(kind)

    def seq_shard(t):
        # Megatron-SP: keep residual adds sequence-sharded so the backward
        # of TP output projections reduce-scatters instead of all-reducing
        if cfg.act_seq_shard:
            return constrain(t, ("pod", "data"), "model", None)
        return t

    h = L.apply_norm(p["norm1"], cfg, x)
    st = None
    if mixer in REC_MIXERS:
        y, rec = R.TRAIN[mixer](p[mixer], cfg, h)
        if max_len is not None:
            st = {"rec": rec}
    elif mixer == "encattn":
        y = L.attention_train(p["attn"], cfg, h, positions, causal=False)
    elif max_len is None:
        y = L.attention_train(p["attn"], cfg, h, positions,
                              window=attention_window(cfg, kind),
                              pad_mask=pad_mask)
    else:
        y, kv = _attn_train_with_cache(p["attn"], cfg, h, positions,
                                       attention_window(cfg, kind), max_len,
                                       pad_mask)
        st = {"kv": kv}
    x = x + seq_shard(y)
    if mixer == "xattn":
        hx = L.apply_norm(p["norm_x"], cfg, x)
        x = x + seq_shard(L.attention_train(p["xattn"], cfg, hx, positions,
                                            kv_override=enc_out))
    if ffn == "none":
        return x, None, st
    h2 = L.apply_norm(p["norm2"], cfg, x)
    if ffn == "mlp":
        return x + seq_shard(L.apply_mlp(p["mlp"], cfg, h2)), None, st
    B, S, D = h2.shape
    y2d, aux = M.moe_apply_dispatch(
        p["moe"], cfg, h2.reshape(B * S, D),
        token_mask=None if pad_mask is None else pad_mask.reshape(B * S))
    return x + seq_shard(y2d.reshape(B, S, D)), aux["load_balance"], st


def forward_train(params, cfg: ModelConfig, batch, *, remat: bool = False,
                  want_state: bool = False, max_len: int = 0):
    """Teacher-forced logits of ``batch["tokens"]`` (B, S) int tensor (with
    an optional left-pad ``batch["pad_mask"]``, a tensor or a host bool
    array, on a config with image tokens an optional
    ``batch["image_embeds"]`` (B, n, D), :func:`_embed_inputs`, and on an
    encoder-decoder the frontend's ``batch["audio_embeds"]`` (B, S_e, D),
    through the encoder first, :func:`_run_encoder`).  Returns
    ``(logits (B, S, V) float32, {"load_balance": sum over MoE layers})``.
    ``remat`` recomputes each period's blocks in the backward pass and
    keeps only the residual stream between periods (the reference's
    ``jax.checkpoint`` of its scan body); tail layers run outside it.

    ``want_state`` also returns the decode state the prompt leaves (the
    static engine's prefill): every attention layer's KV ring of
    ``max_len`` (default S) positions (:func:`_attn_train_with_cache`),
    every recurrent layer's final carry, the encoder-KV plane
    (``enc_kv``, :func:`_collect_enc_kv`) on an encoder-decoder, and
    ``pos``, S for every row, or with a pad mask each row's real-token
    count as a host (B,) array: the per-row positions decode continues
    from."""
    check_supported(cfg)
    x = constrain(_embed_inputs(params, cfg, batch), ("pod", "data"), None,
                  None)
    enc_out = None
    if cfg.is_encoder_decoder:
        if batch.get("audio_embeds") is None:
            raise ValueError(
                f"{cfg.name} is encoder-decoder: the batch needs "
                f"'audio_embeds' (B, encoder_seq, d_model)")
        enc_out = _run_encoder(params, cfg, batch["audio_embeds"],
                               remat=remat and not want_state)
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
        if cfg.act_seq_shard:
            # sequence-parallel residual stream (shards the remat stack)
            x = constrain(x, ("pod", "data"), "model", None)
        for i, lp in enumerate(layer_params):
            x, term, st = _block_train(lp, cfg, kinds[i], x, positions,
                                       pad_mask, ring_len, enc_out)
            if term is not None:
                lb = lb + term
            if want_state:
                states.append(st)
        return x, lb

    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    n_body = cfg.n_periods * period
    for start in range(0, n_body, period):
        lps = params["layers"][start: start + period]
        if remat and torch.is_grad_enabled() and not want_state:
            x, lb = torch.utils.checkpoint.checkpoint(
                run_period, x, lb, *lps, use_reentrant=False)
        else:
            x, lb = run_period(x, lb, *lps)
    # the tail layers (pattern positions 0 .. n_tail - 1), never rematted
    x, lb = run_period(x, lb, *params["layers"][n_body:])
    logits, aux = apply_head(params, cfg, x), {"load_balance": lb}
    if not want_state:
        return logits, aux
    pos = (S if pad_mask is None
           else mask_host.astype(bool).sum(1).astype(np.int32))
    state = {"layers": states, "pos": pos}
    if enc_out is not None:
        state["enc_kv"] = _collect_enc_kv(params, cfg, enc_out)
    return logits, aux, state


def _run_encoder(params, cfg: ModelConfig, audio_embeds, remat: bool = False):
    """The encoder over the frontend's embeddings (B, S_e, D), a tensor or
    a host array, cast to the model dtype first: its ``encattn+mlp``
    blocks at positions ``arange(S_e)``, then its final norm.  ``remat``
    recomputes each block in the backward pass."""
    dev = params["embed"]["table"].device
    x = torch.as_tensor(audio_embeds, device=dev).to(L._dt(cfg))
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    block = lambda x, lp: _block_train(lp, cfg, ENCODER_KIND, x, pos,
                                       None)[0]
    for lp in params["encoder"]["layers"]:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block, x, lp,
                                                  use_reentrant=False)
        else:
            x = block(x, lp)
    return L.apply_norm(params["encoder"]["final_norm"], cfg, x)


def _collect_enc_kv(params, cfg: ModelConfig, enc_out):
    """The encoder-KV plane of ``enc_out`` (B, S_e, D): every decoder
    layer's cross-attention K and V, stacked (n_layers, B, S_e, Hkv,
    hd)."""
    kv = [L.precompute_cross_kv(lp["xattn"], cfg, enc_out)
          for lp in params["layers"]]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def encode_enc_kv(params, cfg: ModelConfig, audio_embeds):
    """The encoder pass and the encoder-KV plane of ``audio_embeds`` (B,
    S_e, D): what admission computes once per request."""
    return _collect_enc_kv(params, cfg, _run_encoder(params, cfg,
                                                     audio_embeds))


def enc_kv_layer(state, l: int, row=None):
    """Layer ``l``'s (k, v) rows of the encoder-KV plane, views (row
    ``row`` alone for a row chunk), or None without a plane."""
    plane = state.get("enc_kv")
    if plane is None:
        return None
    rows = slice(None) if row is None else slice(row, row + 1)
    return plane["k"][l, rows], plane["v"][l, rows]


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
def block_decode(p, cfg: ModelConfig, kind: str, x_t, state, pos, step=None,
                 *, active=None, row=None, enc_kv=None):
    """One plain block's step: the mixer (attention over a dense KV ring,
    or the prepared per-row or paged ``step``; a recurrent mixer from its
    carried state; ``xattn`` then cross-attention over ``enc_kv``,
    :func:`decode_block_packed_mixer`), then the MoE by the
    per-token gather over the dense expert stack, the dense MLP, or
    nothing.  Returns (x_t, state, info); info is ``{"route": {ids,
    weights, probs}, "hidden_pre_moe": (B*C, D)}`` for an MoE block, ``{}``
    otherwise (the reference's ``_block_decode(moe_mode="gather")``)."""
    x_t, state, h2 = decode_block_packed_mixer(p, cfg, kind, x_t, state, pos,
                                               step=step, active=active,
                                               row=row, enc_kv=enc_kv)
    ffn = parse_block(kind)[1]
    if ffn == "none":
        return x_t, state, {}
    B, S, D = h2.shape
    h2d = h2.reshape(B * S, D)
    if ffn == "moe":
        y2d, route = M.moe_apply_gather(p["moe"], cfg, h2d)
        info = {"route": route, "hidden_pre_moe": h2d}
    else:
        y2d, info = L.apply_mlp(p["mlp"], cfg, h2d), {}
    return x_t + y2d.reshape(B, S, D), state, info


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                collect_info: bool = False, active=None, row=None,
                step=None):
    """The plain plane's step: tokens (B, C) at each row's position (C = 1
    decode, C > 1 a prompt chunk or a draft-and-verify chunk, whose
    attention over an unwrapped lock-step dense ring takes the flash
    binding).  KV is written in place.  Returns ``(logits (B, C, V),
    state)``, and the per-layer infos (:func:`block_decode`) with
    ``collect_info``.

    * Dense rings, ``pos`` an int: the rows in lock-step; ``pos``
      advances by C.
    * Dense rings, ``pos`` a host (B,) array (continuous batching, a
      left-padded batch): C tokens per row from its own position; every
      row computes, writes its own ring row and advances C (``active`` is
      not needed: a free slot's writes stay in its row).
    * Paged states (``"pages"``): ``active`` (B,) bool gates which rows
      write KV and advance (the others advance 0), and ``row=slot`` runs
      tokens (1, C) as that row's chunk against the shared page pools,
      through the ragged binding, advancing only that row.

    A recurrent layer steps its carry: at C = 1 by its decode form, at C
    > 1 by its chunk form; rows outside ``active`` keep their carry bit
    for bit (dense or paged), and a row chunk reads and writes its row's
    carry alone.  An ``xattn`` layer's cross-attention reads its layer of
    the encoder-KV plane (a row chunk its row alone).

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
            pos, step, active=active, row=row,
            enc_kv=enc_kv_layer(state, l, row))
        infos.append(info)
    logits = apply_head(params, cfg, x)
    state = dict(state, pos=advance(state, C, active=active, row=row))
    return (logits, state, infos) if collect_info else (logits, state)


def attention_windows(cfg: ModelConfig):
    """The distinct attention windows of the stack's KV layers, in layer
    order (one ragged work list each; none on a pure-recurrent stack)."""
    return tuple(dict.fromkeys(attention_window(cfg, k)
                               for k in cfg.layer_kinds()
                               if MIXER_STATE[parse_block(k)[0]] == "kv"))


def _page_size(state) -> int:
    """The page size of a paged state: its first KV layer's; 1 on a
    stack without one (its page table maps nothing)."""
    for blk in state["layers"]:
        if "kv" in blk:
            return int(blk["kv"]["ppos"].shape[1])
    return 1


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
                            _page_size(state), device, attention_windows(cfg), staging,
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
                              pos, pages=None, active=None, step=None,
                              row=None, enc_kv=None):
    """Mixer half of a block's step (every plane): norm1 + mixer +
    residual, plus the pre-FFN norm.  x_t: (B, C, D).  Attention writes
    the KV ring in ``state["kv"]`` at ``pos .. pos+C-1``, at each row's
    own position with a ``layers.RingStep``, or with ``pages`` (or a
    prepared ``layers.PagedStep``) the page pool at each row's own
    positions, active rows only.  A recurrent mixer steps
    ``state["rec"]`` (:func:`_rec_step`).  ``xattn`` adds ``norm_x`` and
    cross-attention over ``enc_kv`` = (k, v) (B, S_e, Hkv, hd) and its
    residual.  Returns (x_t, state, h2 (B, C, D), or None on a block
    without an FFN)."""
    mixer, ffn = parse_block(kind)
    h = L.apply_norm(p["norm1"], cfg, x_t)
    if mixer in REC_MIXERS:
        y, rec = _rec_step(p[mixer], cfg, mixer, h, state["rec"],
                           active=active, step=step, row=row)
        state = dict(state, rec=rec)
    else:
        y, kv = L.attention_decode(p["attn"], cfg, h, state["kv"], pos,
                                   window=attention_window(cfg, kind),
                                   pages=pages, active=active, step=step)
        state = dict(state, kv=kv)
    x_t = x_t + y
    if mixer == "xattn":
        hx = L.apply_norm(p["norm_x"], cfg, x_t)
        x_t = x_t + L.cross_attention_decode(p["xattn"], cfg, hx, *enc_kv)
    if ffn == "none":
        return x_t, state, None
    return x_t, state, L.apply_norm(p["norm2"], cfg, x_t)


def _active_rows(active, step, C: int, device):
    """The (r,) long device indices of the active rows, or None when every
    row is active: from the prepared step's token rows where there is
    one, else uploaded."""
    if active is None:
        return None
    act = np.asarray(active, bool)
    if act.all():
        return None
    if step is not None:
        return step.rows.view(-1, C)[:, 0] // C
    return torch.as_tensor(np.flatnonzero(act), device=device)


def _rec_step(p, cfg: ModelConfig, mixer: str, h, rec, *, active=None,
              step=None, row=None):
    """A recurrent mixer's step over h (B, C, D): the decode form at C = 1,
    the chunk form at C > 1 (the reference's ``_mixer_decode``).  With
    ``row`` (h is that row's (1, C, D) chunk) only that row's carry is read
    and written back, in place; otherwise rows outside ``active`` keep
    their carry bit for bit (the reference's ``_gate_rows``).  Returns
    (y, rec)."""
    C = h.shape[1]
    fn = R.DECODE[mixer] if C == 1 else R.CHUNK[mixer]
    if row is not None:
        y, new = fn(p, cfg, h, {k: v[row: row + 1] for k, v in rec.items()})
        for k, v in rec.items():
            v[row] = new[k][0]
        return y, rec
    y, new = fn(p, cfg, h, rec)
    idx = _active_rows(active, step, C, h.device)
    if idx is not None:
        new = {k: rec[k].index_copy(0, idx, v.index_select(0, idx))
               for k, v in new.items()}
    return y, new


def decode_block_packed_moe(p, cfg: ModelConfig, x_t, h2, store, pstate,
                            l_moe: int, routers=None, *, lookahead: int = 1,
                            n_spec: int = 0, active=None, rows_dev=None,
                            fused: bool = True, vectorized: bool = True,
                            overlap: bool = True, mark=None):
    """MoE half of a packed block's decode step over B rows of C tokens
    (C = 1 in decode, k + 1 in a verify chunk): route + acquire (+ the
    lookahead layer's staging) + packed compute + residual, over the
    B * C token rows in token-major order (row b's tokens at ``b * C +
    j``, the reference's route-id order).  ``active`` (B,) is per row and
    is repeated over each row's tokens; ``rows_dev`` already lists token
    rows.  ``fused``/``vectorized``/``overlap`` select the plane
    (``moe.moe_apply_packed``, which also takes ``mark``).  Returns (x_t,
    pstate, info)."""
    B, S, D = h2.shape
    h2d = h2.reshape(B * S, D)
    act_tok = None if active is None else np.repeat(np.asarray(active, bool), S)
    y2d, route, pstate = M.moe_apply_packed(
        p["moe"], cfg, h2d, store, pstate, l_moe, routers,
        lookahead=lookahead, n_spec=n_spec, active=act_tok, rows_dev=rows_dev,
        fused=fused, vectorized=vectorized, overlap=overlap, mark=mark)
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
def layer_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """The block kind of layer ``layer_idx`` (tail layers included: they
    take the pattern's positions from 0)."""
    return cfg.block_pattern[layer_idx % cfg.pattern_period]


def attention_window(cfg: ModelConfig, kind: str):
    """The sliding window of a block kind's attention (None: global)."""
    return cfg.sliding_window if parse_block(kind)[0] == "swa" else None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device, *, kv_pages: int = None, kv_page: int = None,
                      kv_max_pages: int = None) -> Dict[str, Any]:
    """One dense KV ring per attention layer (SWA layers ring at the
    window), one zero recurrent state per recurrent layer (``{"rec":
    ...}``, B rows), and the shared start position of the next chunk.

    ``kv_pages``/``kv_page``/``kv_max_pages`` switch the attention layers
    to block-paged KV: each holds a batch-free pool of ``kv_pages`` pages
    of ``kv_page`` positions, and the state grows a page table ``pages``
    ((batch, kv_max_pages), -1 = unallocated) shared by all layers and
    per-row positions ``pos`` (batch,), both numpy on the host, where the
    serving layer keeps them authoritative.  Recurrent layers keep their
    dense rows either way (a pure-recurrent stack has no pool at all).
    An encoder-decoder's state has the encoder-KV plane ``enc_kv`` (zeros,
    ``batch`` rows) on either layout."""
    check_supported(cfg)
    dev = resolve_device(device)

    def layer(kind):
        mixer = parse_block(kind)[0]
        if mixer in REC_MIXERS:
            return {"rec": R.INIT_STATE[mixer](cfg, batch, dev)}
        if kv_page is not None:
            return {"kv": L.init_paged_attn_cache(cfg, kv_pages, kv_page,
                                                  dev)}
        return {"kv": L.init_attn_cache(cfg, batch, max_len, dev,
                                        attention_window(cfg, kind))}

    state = {"layers": [layer(kind) for kind in cfg.layer_kinds()], "pos": 0}
    if kv_page is not None:
        state.update(pos=np.zeros((batch,), np.int32),
                     pages=np.full((batch, kv_max_pages), -1, np.int32))
    if cfg.is_encoder_decoder:
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        state["enc_kv"] = {k: torch.zeros(shape, dtype=L._dt(cfg), device=dev)
                           for k in ("k", "v")}
    return state


def layer_params(params, cfg: ModelConfig, layer_idx: int):
    return params["layers"][layer_idx]


def embed_tokens(params, cfg: ModelConfig, tokens):
    """(B, S) int -> (B, S, D) embeddings."""
    return L.embed(params["embed"], cfg, tokens)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """The training forward's embeddings: with ``batch["image_embeds"]``
    (B, n, D) on a config with image tokens (the vision-tower stub), the
    first n positions are those embeddings through ``img_proj``."""
    x = embed_tokens(params, cfg, batch["tokens"])
    img = batch.get("image_embeds")
    if cfg.num_image_tokens and img is not None:
        img = torch.as_tensor(img, device=x.device).to(x.dtype)
        img = torch.einsum("bnd,de->bne", img, params["img_proj"])
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    return x


def apply_head(params, cfg: ModelConfig, x):
    """Final norm + unembed."""
    return L.unembed(params, cfg, L.apply_norm(params["final_norm"], cfg, x))
