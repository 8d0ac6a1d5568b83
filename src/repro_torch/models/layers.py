"""Transformer layers of the offloaded-generation slice: RMS norm,
interleaved-pair RoPE, GQA attention over a dense KV ring, embeddings.

The port of the reference's ``models/layers.py``.  Parameters are plain
dicts of tensors with the reference's layouts (``wq: (D, H, hd)``,
``wo: (H, hd, D)``); norms, rotary and softmax run in float32 whatever the
parameter dtype, and every cast sits where the reference puts it.
Attention stays plain PyTorch (the reference's model path does not use a
Pallas kernel for it).  The KV ring is updated in place.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _randn(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


# ----------------------------------------------------------------------
# Norms
def init_norm(cfg, device):
    return {"scale": torch.ones((cfg.d_model,), dtype=_dt(cfg), device=device)}


def apply_norm(p, cfg, x):
    """RMS norm in float32 (the slice's configs are all ``rmsnorm``)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# Rotary position embeddings (partial-fraction aware)
def rope_frequencies(cfg, device):
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=device), exps)
    return inv, rot


def apply_rope(x, positions, cfg):
    """x: (..., S, H, hd); positions: (S,) int shared across the batch."""
    inv, rot = rope_frequencies(cfg, x.device)
    if rot == 0:
        return x
    ang = positions.to(torch.float32)[..., :, None] * inv  # (S, rot/2)
    c = torch.cos(ang).unsqueeze(-2)  # (S, 1, rot/2): broadcast over heads
    s = torch.sin(ang).unsqueeze(-2)
    xr, xp = x[..., :rot], x[..., rot:]
    xf = xr.to(torch.float32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xf.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if rot < x.shape[-1] else yr


# ----------------------------------------------------------------------
# Attention
def init_attention(gen, cfg):
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = 1.0 / math.sqrt(D)
    dt = _dt(cfg)
    return {
        "wq": _randn(gen, (D, H, hd), sc, dt),
        "wk": _randn(gen, (D, Hkv, hd), sc, dt),
        "wv": _randn(gen, (D, Hkv, hd), sc, dt),
        "wo": _randn(gen, (H, hd, D), sc / math.sqrt(2 * cfg.n_layers), dt),
    }


def _project(x, w):
    """x (..., D) @ w (D, *heads) as one 2-D product -> (..., *heads)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _project_q(p, cfg, x):
    return _project(x, p["wq"])


def _project_kv(p, cfg, x):
    return _project(x, p["wk"]), _project(x, p["wv"])


def _out_proj(p, cfg, o):
    w = p["wo"]  # (H, hd, D)
    return o.reshape(o.shape[:-2] + (-1,)) @ w.reshape(-1, w.shape[-1])


def attention_core(q, k, v, qpos, kpos, *, causal, window):
    """Exact GQA attention.

    q: (B, Sq, H, hd)  k, v: (B, Skv, Hkv, hd); qpos: (Sq,) absolute
    positions; kpos: (B, Skv) (-1 = empty slot of the KV ring).
    """
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhgk,bthk->bhgqt", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid = (kpos >= 0)[:, None, :]  # (B, 1, Skv)
    qp = qpos[None, :, None]
    if causal:
        valid = valid & (kpos[:, None, :] <= qp)
    if window is not None:
        valid = valid & ((qp - kpos[:, None, :]) < window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqt,bthk->bqhgk", w, v)
    return o.reshape(B, Sq, H, hd)


def init_attn_cache(cfg, batch, max_len, device, window=None):
    # ``pos`` per ring slot; -1 = empty
    W = min(max_len, window) if window else max_len
    dt = _dt(cfg)
    return {
        "k": torch.zeros((batch, W, cfg.n_kv_heads, cfg.head_dim), dtype=dt,
                         device=device),
        "v": torch.zeros((batch, W, cfg.n_kv_heads, cfg.head_dim), dtype=dt,
                         device=device),
        "pos": torch.full((batch, W), -1, dtype=torch.int32, device=device),
    }


def attention_decode(p, cfg, x_t, cache, cur_pos: int, *, window=None):
    """Decode / prefill-chunk step against the dense KV ring.

    x_t: (B, C, D): the C tokens sit at positions ``cur_pos ..
    cur_pos+C-1`` (the whole batch in lock-step); their K/V are written
    into the ring at those positions modulo its width (wrapping like
    decode writes do), and causal masking keeps intra-chunk attention
    exact.  Requires C <= ring width.  The cache is updated in place.
    """
    B, C = x_t.shape[0], x_t.shape[1]
    W = cache["k"].shape[1]
    assert C <= W, f"chunk of {C} tokens exceeds KV width {W}"
    q = _project_q(p, cfg, x_t)
    k_new, v_new = _project_kv(p, cfg, x_t)
    posq = cur_pos + torch.arange(C, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, posq, cfg)
    k_new = apply_rope(k_new, posq, cfg)
    slots = torch.remainder(posq, W).to(torch.long)
    cache["k"][:, slots] = k_new
    cache["v"][:, slots] = v_new
    cache["pos"][:, slots] = posq
    o = attention_core(q, cache["k"], cache["v"], posq, cache["pos"],
                       causal=True, window=window)
    return _out_proj(p, cfg, o), cache


# ----------------------------------------------------------------------
# Embeddings / unembedding
def init_embedding(gen, cfg):
    return {"table": _randn(gen, (cfg.padded_vocab, cfg.d_model),
                            1.0 / math.sqrt(cfg.d_model), _dt(cfg))}


def init_lm_head(gen, cfg):
    return {"w": _randn(gen, (cfg.d_model, cfg.padded_vocab),
                        1.0 / math.sqrt(cfg.d_model), _dt(cfg))}


def embed(p, cfg, tokens):
    return p["table"][tokens.to(torch.long)]


def unembed(params, cfg, x):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"]["w"])
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, NEG_INF), logits)
    return logits
