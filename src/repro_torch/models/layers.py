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
from repro_torch.sharding.specs import constrain, is_dtensor, shard_offset

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
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        x = _reduced(x)  # reduce a partial residual in the model dtype
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
    if is_dtensor(w):
        return _project_sharded(x, w)
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _mm(x, w):
    """x (..., K) @ w (K, N); on a DTensor weight the local region of
    :func:`_project_sharded` (DTensor's own choice for a matmul over an
    FSDP-split contraction dim can replicate the whole batch)."""
    return _project_sharded(x, w) if is_dtensor(w) else x @ w


def _project_sharded(x, w):
    """:func:`_project` of DTensors as a local region, per mesh dim:
    where x's batch is split, w is gathered (FSDP) and its gradient is a
    partial sum; where w's contraction dim D is split, x's D is split
    alike and the output is a partial sum (the reduction is left to the
    next constraint); where w's heads are split, the output's heads are,
    and x is whole (its gradient a partial sum); else all replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    xd = x.ndim - 1
    rows = []
    for a, b in zip(x.placements, w.placements):
        if a == Shard(0):
            rows.append((Shard(0), Replicate(), Shard(0), Shard(0),
                         Partial()))
        elif b == Shard(0):
            rows.append((Shard(xd), Shard(0), Partial(), Shard(xd),
                         Shard(0)))
        elif b == Shard(1):
            rows.append((Replicate(), Shard(1), Shard(xd), Partial(),
                         Shard(1)))
        else:
            rows.append((Replicate(),) * 5)
    px, pw, po, gx, gw = (tuple(c) for c in zip(*rows))
    f = lambda xl, wl: (xl @ wl.reshape(wl.shape[0], -1)).reshape(
        xl.shape[:-1] + wl.shape[1:])
    return local_map(lambda xl, wl: (f(xl, wl),), out_placements=(po,),
                     in_placements=(px, pw), in_grad_placements=(gx, gw),
                     device_mesh=w.device_mesh, redistribute_inputs=True)(
        x, w)[0]


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
    y = _mm(o.reshape(o.shape[:-2] + (-1,)), w.reshape(-1, w.shape[-1]))
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
    if is_dtensor(q):
        return _attention_core_sharded(q, k, v, qpos, kpos, causal=causal,
                                       window=window, q_chunk=q_chunk)
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


def _attention_core_sharded(q, k, v, qpos, kpos, *, causal, window,
                            q_chunk):
    """:func:`attention_core` on DTensors, as a local region per rank.
    Per mesh dim: the batch axis as q's; the key axis as k's (a decode
    ring split over ranks, whose queries are then whole on that dim);
    otherwise q heads on the dim that divides them, k/v heads with them
    where they divide too.  A rank's q heads meet their own kv heads
    (kv head = global q head // group, from its coordinate); over a split
    key axis each rank attends over its keys and the softmax is combined
    across ranks (max, then sums: exact)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    pq, pk, pqp, pkp, pout = [], [], [], [], []
    kdims, hdim = [], None
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if a == Shard(0) or b == Shard(0):
            row = (Shard(0),) * 5
        elif b == Shard(1):
            kdims.append(i)
            row = (Replicate(), Shard(1), Replicate(), Shard(kpos.ndim - 1),
                   Replicate())
        elif H % n == 0 and hdim is None and (a == Shard(2) or b == Shard(2)):
            hdim = i
            row = (Shard(2), Shard(2) if Hkv % n == 0 else Replicate(),
                   Replicate(), Replicate(), Shard(2))
        else:
            row = (Replicate(),) * 5
        for lst, p in zip((pq, pk, pqp, pkp, pout), row):
            lst.append(p)
    batch_pos = lambda t, pl: tuple(
        Replicate() if p == Shard(0) and t.ndim < 2 else p for p in pl)
    qpos, kpos = (_replicated(t, mesh) for t in (qpos, kpos))

    def local(ql, kl, vl, qp, kp):
        Hl = ql.shape[2]
        if kl.shape[2] * (H // Hkv) != Hl:  # kv heads whole, q heads split
            h0 = mesh.get_coordinate()[hdim] * Hl
            idx = torch.div(torch.arange(h0, h0 + Hl, device=ql.device),
                            H // Hkv, rounding_mode="floor")
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        if not kdims:
            return (attention_core(ql, kl, vl, qp, kp, causal=causal,
                                   window=window, q_chunk=q_chunk),)
        return (_attention_split_keys(ql, kl, vl, qp, kp, causal, window,
                                      [(mesh, i) for i in kdims]),)

    # whole kv heads serving split q heads: each rank's k/v gradient is
    # a partial sum
    gk = tuple(Partial() if i == hdim and p == Replicate() else p
               for i, p in enumerate(pk))
    pos_pl = (batch_pos(qpos, pqp), batch_pos(kpos, pkp))
    return local_map(local, out_placements=(tuple(pout),),
                     in_placements=(tuple(pq), tuple(pk), tuple(pk))
                     + pos_pl,
                     in_grad_placements=(tuple(pq), gk, gk) + pos_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, qpos, kpos)[0]


def _replicated(t, mesh):
    """A plain tensor as a DTensor replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _attention_split_keys(q, k, v, qpos, kpos, causal, window, groups):
    """This rank's share of attention over keys split across the mesh
    dims ``groups``: scores over its keys, the max and the softmax sum
    reduced across ranks, P.V summed across ranks (in float32, then cast
    to q's dtype)."""
    import torch.distributed._functional_collectives as funcol

    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    qpos = qpos.expand(B, Sq)
    kpos = kpos.expand(B, k.shape[1])
    s = torch.einsum("bqhgk,bthk->bhgqt", qg.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    valid = (kpos >= 0)[:, None, :]
    qp = qpos[:, :, None]
    if causal:
        valid = valid & (kpos[:, None, :] <= qp)
    if window is not None:
        valid = valid & ((qp - kpos[:, None, :]) < window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    for g in groups:
        den = funcol.all_reduce(den, "sum", g)
    w = (p / den).to(q.dtype)
    o = torch.einsum("bhgqt,bthk->bqhgk", w, v).to(torch.float32)
    for g in groups:
        o = funcol.all_reduce(o, "sum", g)
    return o.to(q.dtype).reshape(B, Sq, H, hd)


def attend_all(q, k, v):
    """Bidirectional attention of q (B, Sq, H, hd) over every key of k, v
    (B, Skv, Hkv, hd): the encoder's self-attention and cross-attention
    over the encoder's K/V, whose keys are all valid.  Through the flash
    binding with ``causal=False`` on (B, H, S, hd) views (k and v read in
    place); under autograd (training) or on a mesh (DTensors) plain
    :func:`attention_core`, as the flash kernel has no backward and takes
    no shards.  Flash keeps the softmax weights in
    float32 through P.V where ``attention_core`` rounds them to the model
    dtype first: equal in float32, one rounding of P apart in bfloat16."""
    if is_dtensor(q) or (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (q, k, v))):
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
        q, k, v = _heads_sharded(q, k, v)
        return _out_proj(p, cfg, attend_all(q, k, v))
    k, v = _project_kv(p, cfg, x)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    q, k, v = _heads_sharded(q, k, v)
    if not causal and window is None and pad_mask is None:
        return _out_proj(p, cfg, attend_all(q, k, v))
    kpos = positions
    if pad_mask is not None:
        kpos = torch.where(pad_mask, positions.expand(pad_mask.shape),
                           torch.full_like(pad_mask, -1, dtype=positions.dtype))
    o = attention_core(q, k, v, positions, kpos, causal=causal, window=window)
    return _out_proj(p, cfg, o)


def _heads_sharded(q, k, v):
    """Megatron-SP layout: full-sequence, head-sharded q, k, v (batch on
    the batch axes, heads on ``"model"`` where they divide it).  Without
    it a sequence-sharded residual stream would leave q sequence-sharded
    and re-gather it per query chunk."""
    return tuple(constrain(t, ("pod", "data"), None, "model", None)
                 for t in (q, k, v))


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
    if is_dtensor(cache["k"]):
        host = [(int(cur_pos) + j) % W for j in range(C)]
        for name, val in (("k", k_new), ("v", v_new),
                          ("pos", posq.expand(B, C))):
            _put_slots_sharded(cache[name], host, val)
    else:
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


def _rows_local(val, buf):
    """This rank's rows of ``val`` (B, n, ...) beside the DTensor ring
    ``buf`` (B, W, ...): split as buf's except along the ring axis."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(val, DTensor):
        pl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
                   for p in buf.placements)
        return val.redistribute(buf.device_mesh, pl).to_local()
    off, rows = shard_offset(buf, 0)
    return val[off: off + rows]


def _put_slots_sharded(buf, slots, val):
    """``buf[:, slots] = val`` in place on a DTensor ring buf (B, W, ...)
    whose W axis may be sharded: each rank writes the host-known
    ``slots`` that fall in its shard."""
    off, w = shard_offset(buf, 1)
    loc, v = buf.to_local(), _rows_local(val, buf)  # every rank joins
    mine = [(j, s - off) for j, s in enumerate(slots) if off <= s < off + w]
    if not mine:
        return
    src = torch.tensor([j for j, _ in mine], device=loc.device)
    dst = torch.tensor([s for _, s in mine], device=loc.device)
    loc[:, dst] = v[:, src].to(loc.dtype)


def ring_write(buf, slots, val):
    """``buf[b, slots[b, j]] = val[b, j]`` in place: a ring buf (B, W,
    ...), slots (B, n) long, at most one write per slot and row.  On a
    DTensor ring each rank fills the slots of its W shard by a gather
    (no host sync, so it also runs on ``meta``)."""
    if not is_dtensor(buf):
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[bidx, slots] = val
        return
    off, w = shard_offset(buf, 1)
    loc, v = buf.to_local(), _rows_local(val, buf)
    sl = _rows_local(slots, buf) - off
    Bl, n = sl.shape
    ok = (sl >= 0) & (sl < w)
    src = torch.full((Bl, w + 1), -1, dtype=torch.long, device=loc.device)
    src.scatter_(1, torch.where(ok, sl, torch.full_like(sl, w)),
                 torch.arange(n, device=loc.device).expand(Bl, n))
    src = src[:, :w]
    idx = src.clamp(min=0).view((Bl, w) + (1,) * (v.ndim - 2))
    got = torch.gather(v.to(loc.dtype), 1, idx.expand((Bl, w) + v.shape[2:]))
    have = (src >= 0).view(idx.shape)
    loc.copy_(torch.where(have, got, loc))


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
        g = _mm(x, p["w_gate"])
        u = _mm(x, p["w_up"])
        act = torch.nn.functional.silu if cfg.mlp_act == "swiglu" else gelu
        h = act(g.to(torch.float32)).to(x.dtype) * u
        h = constrain(h, ("pod", "data"), *[None] * (h.ndim - 2), "model")
        return _mm(h, p["w_down"])
    h = gelu(_mm(x, p["w_in"]).to(torch.float32)).to(x.dtype)
    h = constrain(h, ("pod", "data"), *[None] * (h.ndim - 2), "model")
    return _mm(h, p["w_out"])


# ----------------------------------------------------------------------
# Embeddings / unembedding
def init_embedding(gen, cfg):
    return {"table": _randn(gen, (cfg.padded_vocab, cfg.d_model),
                            1.0 / math.sqrt(cfg.d_model), _dt(cfg))}


def init_lm_head(gen, cfg):
    return {"w": _randn(gen, (cfg.d_model, cfg.padded_vocab),
                        1.0 / math.sqrt(cfg.d_model), _dt(cfg))}


def embed(p, cfg, tokens):
    if is_dtensor(p["table"]):
        return _embed_sharded(p["table"], tokens)
    return p["table"][tokens.to(torch.long)]


def _embed_sharded(table, tokens):
    """The lookup on a DTensor table as a local region: the table
    gathered where the tokens' batch is split (FSDP), and where its vocab
    axis is split each rank looks up the ids of its shard and leaves a
    partial sum (zeros elsewhere)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = []
    for a, b in zip(tokens.placements, table.placements):
        if a == Shard(0):
            rows.append((Shard(0), Replicate(), Shard(0), Partial()))
        elif b == Shard(0):
            rows.append((Replicate(), Shard(0), Partial(), Shard(0)))
        else:
            rows.append((Replicate(),) * 4)
    pt, pw, po, gw = (tuple(c) for c in zip(*rows))
    off = shard_offset(table, 0, pw)[0]

    def local(tok, w):
        idx = tok.to(torch.long) - off
        own = (idx >= 0) & (idx < w.shape[0])
        x = w[idx.clamp(0, w.shape[0] - 1)]
        return (x * own[..., None].to(x.dtype),)

    return local_map(local, out_placements=(po,), in_placements=(pt, pw),
                     in_grad_placements=(pt, gw),
                     device_mesh=table.device_mesh,
                     redistribute_inputs=True)(tokens, table)[0]


def _reduced(x):
    """A DTensor with its partial sums reduced (Partial -> Replicate)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def unembed(params, cfg, x):
    if is_dtensor(x):  # vocab-parallel: a rank's logits over its vocab shard
        w = params["embed"]["table"].t() if cfg.tie_embeddings \
            else params["lm_head"]["w"]
        logits = _project(x, w)
    elif cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"]["w"])
    logits = logits.to(torch.float32)
    # keep the (huge) vocab axis model-sharded; CE reduces it locally
    logits = constrain(logits, ("pod", "data"), None, "model")
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, NEG_INF), logits)
    if cfg.logit_softcap:
        # after the pad mask, as in the reference: a pad id's logit ends at
        # -softcap, not -inf (ROADMAP section 3)
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
