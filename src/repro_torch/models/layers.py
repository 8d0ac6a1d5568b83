"""Transformer layers of the ported slices: RMS norm and layernorm,
interleaved-pair (partial) RoPE, GQA attention (optional qkv and output
biases) over a dense KV ring or block-paged KV, cross-attention over an
encoder's K/V, dense MLPs, embeddings and
the (optionally soft-capped) unembedding.

The port of the reference's ``models/layers.py``.  Parameters are plain
dicts of tensors with the reference's layouts (``wq: (D, H, hd)``,
``wo: (H, hd, D)``); norms, rotary and softmax run in float32 whatever the
parameter dtype, and every cast sits where the reference puts it.
A prefill chunk over a dense ring that has not wrapped attends through
the flash-attention binding (``kernels/ops.flash_attention``), and so does,
non-causal, bidirectional attention over all keys (an encoder's
self-attention, cross-attention over its K/V) outside autograd; decode
steps (in lock-step or at per-row positions) and chunks that wrap the
ring stay plain PyTorch (``attention_core``, the reference's model
path); attention over paged KV goes through the ragged paged-attention
binding (``kernels/ops.ragged_attention``).
KV rings and page pools are updated in place.  Dense MLPs
(:func:`apply_mlp`) are plain products, as in the reference.  The
training forward's full-sequence attention (:func:`attention_train`) is
plain, query-chunked PyTorch under autograd.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels import ragged_attention as RA

DEFAULT_Q_CHUNK = 512
NEG_INF = -1e30


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _randn(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


# ----------------------------------------------------------------------
# Norms
def init_norm(cfg, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=_dt(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=device)
    return p


def apply_norm(p, cfg, x):
    """RMS norm, or layernorm (a ``bias`` leaf and ``cfg.norm ==
    "layernorm"``), in float32."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm" and "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# Rotary position embeddings (partial-fraction aware)
def rope_frequencies(cfg, device):
    """The rotary inverse frequencies (rot/2,) float32 and the rotated
    width.  Everything is made on ``device`` by kernels: a tensor copied
    from host data would synchronise the stream twice per attention
    layer per step."""
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    theta = torch.full((), cfg.rope_theta, dtype=torch.float32, device=device)
    inv = 1.0 / torch.pow(theta, exps)
    return inv, rot


def apply_rope(x, positions, cfg):
    """x: (..., S, H, hd); positions: (S,) int shared across the batch, or
    (B, S) per row."""
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
    """An attention layer's projections (and biases); a cross-attention
    layer (an encoder-decoder's ``xattn``) has the same leaves, its K/V
    projecting the encoder's output."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = 1.0 / math.sqrt(D)
    dt = _dt(cfg)
    p = {
        "wq": _randn(gen, (D, H, hd), sc, dt),
        "wk": _randn(gen, (D, Hkv, hd), sc, dt),
        "wv": _randn(gen, (D, Hkv, hd), sc, dt),
        "wo": _randn(gen, (H, hd, D), sc / math.sqrt(2 * cfg.n_layers), dt),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dt, device=dev)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((D,), dtype=dt, device=dev)
    return p


def _project(x, w):
    """x (..., D) @ w (D, *heads) as one 2-D product -> (..., *heads)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _project_q(p, cfg, x):
    q = _project(x, p["wq"])
    return q + p["bq"] if "bq" in p else q


def _project_kv(p, cfg, x):
    k, v = _project(x, p["wk"]), _project(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _out_proj(p, cfg, o):
    w = p["wo"]  # (H, hd, D)
    y = o.reshape(o.shape[:-2] + (-1,)) @ w.reshape(-1, w.shape[-1])
    return y + p["bo"] if "bo" in p else y


def attention_core(q, k, v, qpos, kpos, *, causal, window,
                   q_chunk=DEFAULT_Q_CHUNK):
    """Exact query-chunked GQA attention.

    q: (B, Sq, H, hd)  k, v: (B, Skv, Hkv, hd); qpos: (Sq,) or (B, Sq)
    absolute positions (per row in continuous batches); kpos: (Skv,) or
    (B, Skv) (-1 = empty ring slot, unallocated page or pad).

    Scores are materialised ``q_chunk`` query rows at a time in float32
    (``Sq % q_chunk`` falls back to one chunk); the softmax weights are
    cast to q's dtype before P.V, as in the reference.  Under autograd
    each chunk of several is recomputed in the backward pass instead of
    storing its scores (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its chunk body).
    """
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = qpos.expand(B, Sq)
    kpos = kpos.expand(B, k.shape[1])
    kf = k.to(torch.float32)

    def chunk(qc, qp):
        s = torch.einsum("bqhgk,bthk->bhgqt", qc.to(torch.float32), kf) * scale
        valid = (kpos >= 0)[:, None, :]  # (B, 1, Skv)
        qp = qp[:, :, None]
        if causal:
            valid = valid & (kpos[:, None, :] <= qp)
        if window is not None:
            valid = valid & ((qp - kpos[:, None, :]) < window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhgqt,bthk->bqhgk", w, v)

    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk:
        q_chunk = Sq
    if q_chunk == Sq:
        o = chunk(qg, qpos)
    else:
        run = chunk
        if torch.is_grad_enabled():
            run = lambda a, b: torch.utils.checkpoint.checkpoint(
                chunk, a, b, use_reentrant=False)
        o = torch.cat([run(qg[:, a: a + q_chunk], qpos[:, a: a + q_chunk])
                       for a in range(0, Sq, q_chunk)], dim=1)
    return o.reshape(B, Sq, H, hd)


def attend_all(q, k, v):
    """Bidirectional attention of q (B, Sq, H, hd) over every key of k, v
    (B, Skv, Hkv, hd): the encoder's self-attention and cross-attention
    over the encoder's K/V, whose keys are all valid.  Through the flash
    binding with ``causal=False`` on (B, H, S, hd) views (k and v read in
    place); under autograd (training) plain :func:`attention_core`, as the
    flash kernel has no backward.  Flash keeps the softmax weights in
    float32 through P.V where ``attention_core`` rounds them to the model
    dtype first: equal in float32, one rounding of P apart in bfloat16."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
        return attention_core(q, k, v, kpos[:1], kpos, causal=False,
                              window=None)
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               causal=False).transpose(1, 2)


def attention_train(p, cfg, x, positions, *, window=None, causal=True,
                    pad_mask=None, kv_override=None):
    """Full-sequence attention (the training forward, the static prefill,
    the encoder): x (B, S, D) at ``positions`` (S,) or (B, S).
    ``pad_mask`` (B, S) bool, True at real tokens, removes pads from every
    key set (their own query rows are garbage that callers ignore).
    ``kv_override`` (B, S_e, D), the encoder's output, makes it
    cross-attention: K and V project it, neither q nor K gets RoPE, and
    every query sees every frame (non-causal, no window).  Causal
    attention is plain PyTorch through :func:`attention_core`,
    differentiable; bidirectional attention over all keys goes through
    :func:`attend_all`."""
    q = _project_q(p, cfg, x)
    if kv_override is not None:
        k, v = _project_kv(p, cfg, kv_override)
        return _out_proj(p, cfg, attend_all(q, k, v))
    k, v = _project_kv(p, cfg, x)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    if not causal and window is None and pad_mask is None:
        return _out_proj(p, cfg, attend_all(q, k, v))
    kpos = positions
    if pad_mask is not None:
        kpos = torch.where(pad_mask, positions.expand(pad_mask.shape),
                           torch.full_like(pad_mask, -1, dtype=positions.dtype))
    o = attention_core(q, k, v, positions, kpos, causal=causal, window=window)
    return _out_proj(p, cfg, o)


def cross_attention_decode(p, cfg, x_t, enc_k, enc_v):
    """Cross-attention of a decode step or chunk x_t (B, C, D) over the
    encoder-KV plane's rows enc_k, enc_v (B, S_e, Hkv, hd), read in place
    (:func:`attend_all`)."""
    return _out_proj(p, cfg, attend_all(_project_q(p, cfg, x_t), enc_k,
                                        enc_v))


def precompute_cross_kv(p, cfg, enc_out):
    """The cross-attention K, V (B, S_e, Hkv, hd) of the encoder's output:
    computed once per request, read by every decode step."""
    return _project_kv(p, cfg, enc_out)


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


def attention_decode(p, cfg, x_t, cache, cur_pos, *, window=None,
                     pages=None, active=None, step=None):
    """Decode / prefill-chunk step against the dense KV ring or, with
    ``pages`` or a :class:`PagedStep`, the paged KV plane.

    x_t: (B, C, D): the C tokens sit at positions ``cur_pos ..
    cur_pos+C-1`` (the whole batch in lock-step, ``cur_pos`` an int);
    their K/V are written into the ring at those positions modulo its
    width (wrapping like decode writes do), and causal masking keeps
    intra-chunk attention exact.  Requires C <= ring width.  The cache is
    updated in place.

    Rows at their own positions (continuous batching, a left-padded
    batch) pass a :class:`RingStep`: row b's C tokens (C = 1 in decode,
    k + 1 in a verify chunk) write ring slots ``(pos[b] + j) mod W`` of
    its own ring row and attend through ``attention_core`` with its own
    query positions.  Every row computes and writes: a free slot's
    writes stay in its own ring row.

    A prefill or verify chunk (C > 1) whose last position still fits the ring
    (``cur_pos + C <= W``) attends through the flash binding
    (``ops.flash_attention``) over ring slots ``[0, cur_pos + C)`` with
    ``q_offset = cur_pos``, reading the ring and the queries in place.
    It keeps the softmax weights in float32 through P.V and rounds only
    its output, where ``attention_core`` (the reference's model path)
    rounds the weights to the model dtype first: the same result in
    float32, one rounding of P apart in bfloat16.  A decode step (C = 1,
    the reference's kernel gate sends it to jnp too) attends through
    ``attention_core`` over whatever the ring holds, with its position
    mask.  A chunk that wraps the ring (``cur_pos + C > W``) attends
    through ``attention_core`` over the ring as it was before the write
    plus the chunk's own K/V, and only then writes: written first, query
    ``p`` would lose position ``p + j - W`` to the chunk's own write
    (the reference writes first and loses it).  The ring and ``pos``
    after the step are the reference's either way.

    ``pages`` (B, T) switches to the paged KV plane: ``cache`` is then an
    :func:`init_paged_attn_cache` pool, ``cur_pos`` (B,) per-row start
    positions and ``active`` (B,) bool the rows that may write.  A caller
    that runs many layers passes the prepared ``step`` instead (it holds
    all three, built on the host once)."""
    if step is None and pages is not None:
        host = lambda t: None if t is None else np.asarray(
            t.cpu() if isinstance(t, torch.Tensor) else t)
        pos = np.broadcast_to(host(cur_pos), (x_t.shape[0],))
        step = paged_step(pos, host(pages), host(active), x_t.shape[1],
                          cache["ppos"].shape[1], x_t.device, (window,))
    if isinstance(step, PagedStep):
        return _attention_decode_paged(p, cfg, x_t, cache, step,
                                       window=window)
    if isinstance(step, RingStep):
        return _attention_decode_rows(p, cfg, x_t, cache, step,
                                      window=window)
    B, C = x_t.shape[0], x_t.shape[1]
    W = cache["k"].shape[1]
    assert C <= W, f"chunk of {C} tokens exceeds KV width {W}"
    q = _project_q(p, cfg, x_t)
    k_new, v_new = _project_kv(p, cfg, x_t)
    posq = cur_pos + torch.arange(C, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, posq, cfg)
    k_new = apply_rope(k_new, posq, cfg)
    slots = torch.remainder(posq, W).to(torch.long)
    n = int(cur_pos) + C
    if C > 1 and n > W:
        # the chunk wraps the ring: position p + j would overwrite p + j - W,
        # which query p still sees, so attend over the ring as it was
        # before the write plus the chunk's own K/V, then write
        kpos = torch.cat([cache["pos"], posq.expand(B, C)], dim=1)
        o = attention_core(q, torch.cat([cache["k"], k_new], dim=1),
                           torch.cat([cache["v"], v_new], dim=1), posq, kpos,
                           causal=True, window=window)
    cache["k"][:, slots] = k_new
    cache["v"][:, slots] = v_new
    cache["pos"][:, slots] = posq
    if C > 1 and n <= W:
        # the ring has not wrapped: slot j holds position j for every j < n,
        # the flash kernel's contiguous key positions
        kv = lambda t: t[:, :n].transpose(1, 2)
        o = ops.flash_attention(q.transpose(1, 2), kv(cache["k"]),
                                kv(cache["v"]), causal=True, window=window,
                                q_offset=int(cur_pos)).transpose(1, 2)
    elif C == 1:
        o = attention_core(q, cache["k"], cache["v"], posq, cache["pos"],
                           causal=True, window=window)
    return _out_proj(p, cfg, o), cache


class RingStep(NamedTuple):
    """The per-row inputs of one dense-ring step, built on the host from
    the host-authoritative positions (:func:`ring_step`) and uploaded in
    one copy, with the step's tokens when they are given."""

    posq: torch.Tensor      # (B, C) int32 query positions
    bidx: torch.Tensor      # (B,) long: arange(B)
    rows: torch.Tensor      # (r * C,) long: the token rows of the active rows
    tokens: Optional[torch.Tensor]  # (B, C) int32, or None


def ring_step(pos, C: int, device, staging: Optional[HostStaging] = None,
              active=None, tokens=None) -> RingStep:
    """Build a :class:`RingStep`: ``pos`` (B,) each row's first position,
    C tokens per row (1 in decode, k + 1 in a verify chunk), ``active``
    (B,) bool or None (all rows), ``tokens`` (B, C) host ints or None.
    ``rows`` lists the active rows' token rows ``b * C + j`` (the token-
    major order of the step's B * C rows)."""
    pos = np.asarray(pos, np.int64).reshape(-1)
    B = pos.shape[0]
    act = np.ones(B, bool) if active is None else np.asarray(active, bool)
    rows = (np.flatnonzero(act)[:, None] * C + np.arange(C)).ravel()
    parts = [(pos[:, None] + np.arange(C)).ravel(), np.arange(B), rows]
    if tokens is not None:
        parts.append(np.asarray(tokens).reshape(-1))
    seg = _upload(parts, device, staging)
    return RingStep(posq=seg[0].view(B, C), bidx=seg[1].long(),
                    rows=seg[2].long(),
                    tokens=seg[3].view(B, C) if tokens is not None else None)


def _attention_decode_rows(p, cfg, x_t, cache, step: RingStep, *,
                           window=None):
    """C tokens per row at the row's own positions (the reference's
    per-row ``attention_decode``): row b's K/V go to ring slots
    ``(pos[b] + j) mod W`` of its ring row, then its queries attend over
    its ring with the position mask (``attention_core``, no kernel: no
    binding takes per-row query offsets, and the reference runs no
    kernel here either).  Entries a rollback left past a row's position
    are hidden by ``kpos <= qpos`` until overwritten.  The ring is
    updated in place."""
    W = cache["k"].shape[1]
    C = x_t.shape[1]
    assert C <= W, f"chunk of {C} tokens exceeds KV width {W}"
    q = _project_q(p, cfg, x_t)
    k_new, v_new = _project_kv(p, cfg, x_t)
    q = apply_rope(q, step.posq, cfg)
    k_new = apply_rope(k_new, step.posq, cfg)
    slots = torch.remainder(step.posq, W).long()
    bidx = step.bidx[:, None]
    cache["k"][bidx, slots] = k_new
    cache["v"][bidx, slots] = v_new
    cache["pos"][bidx, slots] = step.posq
    o = attention_core(q, cache["k"], cache["v"], step.posq, cache["pos"],
                       causal=True, window=window, q_chunk=C)
    return _out_proj(p, cfg, o), cache


# ----------------------------------------------------------------------
# Paged KV (the reference's DESIGN.md §9)
def init_paged_attn_cache(cfg, n_pages, page_size, device):
    """One layer's page pool, shared by every slot: ``kp/vp`` (P, ps,
    Hkv, hd) and ``ppos`` (P, ps), the absolute position of each written
    entry (-1 = never written or scrubbed).  Which pages a row owns lives
    in the state's page table, not here."""
    dt = _dt(cfg)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=dt, device=device),
            "vp": torch.zeros(shape, dtype=dt, device=device),
            "ppos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                               device=device)}


class HostStaging:
    """A reusable pinned int32 buffer for one host->device copy at a time:
    :meth:`upload` waits until the previous copy has read the buffer,
    fills it and starts the next copy without blocking."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.done: Optional[torch.cuda.Event] = None

    def upload(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        arr = np.ascontiguousarray(arr, np.int32)
        if device.type != "cuda":
            return torch.from_numpy(arr)
        if self.done is not None:
            self.done.synchronize()
        if self.buf is None or self.buf.numel() < arr.size:
            self.buf = torch.empty((max(arr.size, 1024),), dtype=torch.int32,
                                   pin_memory=True)
        self.buf[: arr.size].numpy()[:] = arr
        out = self.buf[: arr.size].to(device, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()
        return out


def _upload(parts, device, staging: Optional[HostStaging] = None):
    """Host int arrays -> their int32 device copies, made by one upload."""
    flat = (staging or HostStaging()).upload(
        np.concatenate([np.asarray(a, np.int32) for a in parts]), device)
    cut = np.cumsum([0] + [len(a) for a in parts])
    return [flat[a:b] for a, b in zip(cut[:-1], cut[1:])]


class PagedStep(NamedTuple):
    """What every paged attention layer of one decode step or prompt
    chunk needs, built once on the host from the host-authoritative
    positions and page tables (:func:`paged_step`) and uploaded in one
    copy: the query positions, the page table, the (row, position) pairs
    whose K/V land (unallocated table slots and inactive rows write
    nowhere), on the card one ragged work list per attention window, and
    the step's tokens when they are given."""

    posq: torch.Tensor      # (B, C) int32 absolute query positions
    pages: torch.Tensor     # (B, T) int32 page table
    w_src: torch.Tensor     # (n,) long: b * C + c of each write that lands
    w_page: torch.Tensor    # (n,) long
    w_off: torch.Tensor     # (n,) long
    rows: torch.Tensor      # (r * C,) long: the active rows' token rows
    worklists: Dict[Optional[int], RA.DeviceWorklist]
    tokens: Optional[torch.Tensor] = None  # (B, C) int32


def paged_step(pos, pages, active, C: int, page_size: int, device,
               windows: Sequence[Optional[int]] = (None,),
               staging: Optional[HostStaging] = None,
               tokens=None) -> PagedStep:
    """Build a :class:`PagedStep`.  pos (B,): each row's first query
    position; pages (B, T) int; active (B,) bool or None (all rows);
    tokens (B, C) host ints or None.  The work lists (card only; the
    plain path gathers the table instead) list, for each active row, the
    pages of positions ``< pos + C``."""
    pos = np.asarray(pos, np.int64).reshape(-1)
    pages = np.asarray(pages, np.int32)
    B, T = pages.shape
    act = np.ones(B, bool) if active is None else np.asarray(active, bool)
    posq = pos[:, None] + np.arange(C)
    ords, off = posq // page_size, posq % page_size
    pid = np.take_along_axis(pages, np.clip(ords, 0, T - 1), axis=1)
    ok = (pid >= 0) & (ords < T) & act[:, None]
    rows = (np.flatnonzero(act)[:, None] * C + np.arange(C)).ravel()
    parts = [posq.ravel(), pages.ravel(), np.flatnonzero(ok), pid[ok],
             off[ok], rows]
    n_seg = {}
    if device.type == "cuda":
        n_live = np.where(act, pos + C, 0)
        for w in windows:
            wl = RA.build_page_worklist(pages, n_live, pos, pos + C - 1,
                                        page_size, window=w)
            packed, n_seg[w] = RA.pack_worklist(*wl, B)
            parts.append(packed)
    if tokens is not None:
        parts.append(np.asarray(tokens).reshape(-1))
    seg = _upload(parts, device, staging)
    return PagedStep(
        posq=seg[0].view(B, C), pages=seg[1].view(B, T),
        w_src=seg[2].long(), w_page=seg[3].long(), w_off=seg[4].long(),
        rows=seg[5].long(),
        worklists={w: RA.DeviceWorklist(t, n_seg[w])
                   for w, t in zip(n_seg, seg[6: 6 + len(n_seg)])},
        tokens=seg[-1].view(B, C) if tokens is not None else None)


def _attention_decode_paged(p, cfg, x_t, cache, step: PagedStep, *,
                            window=None):
    """Decode / chunk step against the paged KV plane: the C tokens of
    row b sit at ``step.posq[b]``; their K/V go to the pages the table
    maps those positions to, where the step says a write lands (an index
    put of the selected pairs only: nothing is ever written out of
    range), and attention reads the pool through the ragged binding.
    The pool is updated in place."""
    B, C = x_t.shape[0], x_t.shape[1]
    q = _project_q(p, cfg, x_t)
    k_new, v_new = _project_kv(p, cfg, x_t)
    q = apply_rope(q, step.posq, cfg)
    k_new = apply_rope(k_new, step.posq, cfg)
    dst = (step.w_page, step.w_off)
    cache["kp"][dst] = k_new.reshape((B * C,) + k_new.shape[2:])[step.w_src]
    cache["vp"][dst] = v_new.reshape((B * C,) + v_new.shape[2:])[step.w_src]
    cache["ppos"][dst] = step.posq.reshape(-1)[step.w_src]
    o = ops.ragged_attention(q, cache["kp"], cache["vp"], cache["ppos"],
                             step.pages, step.posq, window=window,
                             worklist=step.worklists.get(window))
    return _out_proj(p, cfg, o), cache


# ----------------------------------------------------------------------
# MLPs
def init_mlp(gen, cfg):
    D, F = cfg.d_model, cfg.d_ff
    dt = _dt(cfg)
    sc_in = 1.0 / math.sqrt(D)
    sc_out = 1.0 / math.sqrt(F) / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"w_gate": _randn(gen, (D, F), sc_in, dt),
                "w_up": _randn(gen, (D, F), sc_in, dt),
                "w_down": _randn(gen, (F, D), sc_out, dt)}
    return {"w_in": _randn(gen, (D, F), sc_in, dt),
            "w_out": _randn(gen, (F, D), sc_out, dt)}


def apply_mlp(p, cfg, x):
    """x (..., D) through the gated (swiglu, geglu) or plain (gelu) MLP;
    the activation in float32, as in the reference (its gelu is the tanh
    form, ``jax.nn.gelu``'s default)."""
    gelu = lambda t: torch.nn.functional.gelu(t, approximate="tanh")
    if "w_gate" in p:
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        act = torch.nn.functional.silu if cfg.mlp_act == "swiglu" else gelu
        h = act(g.to(torch.float32)).to(x.dtype) * u
        return h @ p["w_down"]
    h = gelu((x @ p["w_in"]).to(torch.float32)).to(x.dtype)
    return h @ p["w_out"]


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
    if cfg.logit_softcap:
        # after the pad mask, as in the reference: a pad id's logit ends at
        # -softcap, not -inf (ROADMAP section 3)
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
