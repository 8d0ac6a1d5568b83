"""Sparse mixture-of-experts FFN over HQQ-packed experts (port of the
reference's ``models/moe.py``, the paths offloaded generation runs).

* :func:`moe_apply_gather`: per-token gather over a dense expert stack:
  the plain plane's MoE (the dense-resident oracle of the packed paths).
* :func:`moe_apply_packed`: decode of T rows (the busy ones of a
  continuous batch).  The routed experts are served from the layer's
  device pool and its overflow records (``core/expert_pool.acquire``)
  and the kernel reads them in place, by slot
  (``ops.dequant_matmul_slots``).  ``vectorized=False`` is the
  reference's sequential baseline: the accesses are copied one by one
  into a serve tier and each (token, k) pair runs its own three
  ``ops.dequant_matmul`` calls, the only path of that 2-D binding.
* :func:`moe_apply_packed_stream`: prefill.  Each distinct routed expert
  of the layer is copied once into a reusable device tier, the rows are
  sorted into ragged groups by expert, and the grouped kernel runs over
  that tier (``ops.dequant_matmul_batched`` with row offsets); no pool
  state, no counter.

The training forward's paths are plain PyTorch under autograd:
:func:`moe_apply_dispatch` (GShard-style scatter into per-expert
capacity slots, token-major priority, overflow dropped) and
:func:`moe_apply_dense` (every expert for every token: the oracle), with
:func:`aux_losses`' load-balance term.

``fused=False`` (both) dequantizes each served record into the model
dtype (``quant/hqq.dequantize``) and runs plain matrix products, the
reference's gather einsums.  Every compute path keeps the reference's
cast points (``_packed_compute``): gate and up products cast to the model
dtype, the activation in float32, the down product and the
routing-weighted sum in float32.  The kernel computes every output row
independently and in the same order, so a row gets the same bits whether
it is served by slot, in a group or alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import expert_pool as EP
from repro_torch.core import speculative
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import _mm
from repro_torch.quant import hqq
from repro_torch.sharding.specs import (constrain, current_mesh,
                                        is_dtensor, mesh_axis_size,
                                        mesh_names, run_local, shard_offset,
                                        spec_placements)


def init_moe(gen, cfg):
    spec = cfg.moe
    D, F, E = cfg.d_model, cfg.d_ff, spec.num_experts
    dt = getattr(torch, cfg.dtype)
    sc_in = 1.0 / math.sqrt(D)
    sc_out = 1.0 / math.sqrt(F) / math.sqrt(2 * cfg.n_layers)
    dev = gen.device
    rn = lambda shape, sc: (torch.randn(shape, generator=gen, device=dev)
                            * sc).to(dt)
    return {
        "router": torch.randn((D, E), generator=gen, device=dev) * sc_in,
        "experts": {
            "w_gate": rn((E, D, F), sc_in),
            "w_up": rn((E, D, F), sc_in),
            "w_down": rn((E, F, D), sc_out),
        },
    }


def router_logits(p, x2d):
    """(T, E) router logits in float32."""
    return _mm(x2d.to(torch.float32), p["router"].to(torch.float32))


def route_topk(p, spec, x2d) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T,K) f32, ids (T,K) int32, probs (T,E) f32).  On
    a mesh each rank routes its own tokens (a local region)."""
    logits = router_logits(p, x2d)
    tok = (("pod", "data"),)
    return run_local(lambda lg: _topk(lg, spec.top_k), (logits,), (tok,),
                     lambda mesh: (spec_placements(mesh, logits.shape,
                                                   tok),) * 3)


def _topk(logits, k: int):
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # mixtral renorm
    return w, ids.to(torch.int32), probs


def _act(cfg):
    """The expert activation: silu (swiglu) or tanh-form gelu (the
    reference's ``jax.nn.gelu`` default)."""
    if cfg.mlp_act == "swiglu":
        return torch.nn.functional.silu
    return lambda t: torch.nn.functional.gelu(t, approximate="tanh")


def expert_ffn(experts, cfg, xbuf):
    """xbuf (..., E, C, D) -> (..., E, C, D), batched over experts (and
    any leading group axes)."""
    if is_dtensor(xbuf):
        return _expert_ffn_sharded(experts, cfg, xbuf)
    act = _act(cfg)
    g = torch.einsum("...ecd,edf->...ecf", xbuf, experts["w_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xbuf, experts["w_up"])
    h = act(g.to(torch.float32)).to(xbuf.dtype) * u
    return torch.einsum("...ecf,efd->...ecd", h, experts["w_down"])


def _expert_ffn_sharded(experts, cfg, xbuf):
    """:func:`expert_ffn` of a DTensor buffer (g, E, C, D) as a local
    region, per mesh dim: where the groups are split, the weights are
    gathered (FSDP) and their gradients are partial sums; where the
    experts are split (expert parallel), the buffer's E axis is split
    alike; where their hidden dim is split (tensor parallel), the
    buffer is whole and the output (and its gradient) a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = ("w_gate", "w_up", "w_down")
    hidden = {"w_gate": Shard(2), "w_up": Shard(2), "w_down": Shard(1)}
    R = Replicate()
    pb, po, gb = [], [], []
    pw, gw = {n: [] for n in names}, {n: [] for n in names}
    for a, e in zip(xbuf.placements, experts["w_gate"].placements):
        if a == Shard(0):    # groups split: weights gathered
            rows = (Shard(0), Shard(0), Shard(0),
                    {n: (R, Partial()) for n in names})
        elif e == Shard(0):  # experts split
            rows = (Shard(1), Shard(1), Shard(1),
                    {n: (Shard(0), Shard(0)) for n in names})
        elif e == Shard(2):  # experts' hidden dim split
            rows = (R, Partial(), Partial(),
                    {n: (hidden[n], hidden[n]) for n in names})
        else:
            rows = (R, R, R, {n: (R, R) for n in names})
        for lst, p in zip((pb, po, gb), rows[:3]):
            lst.append(p)
        for n in names:
            pw[n].append(rows[3][n][0])
            gw[n].append(rows[3][n][1])
    f = lambda xb, wg, wu, wd: (expert_ffn(
        {"w_gate": wg, "w_up": wu, "w_down": wd}, cfg, xb),)
    ws = [experts[n] for n in names]
    return local_map(
        f, out_placements=(tuple(po),),
        in_placements=(tuple(pb),) + tuple(tuple(pw[n]) for n in names),
        in_grad_placements=(tuple(gb),) + tuple(tuple(gw[n])
                                                for n in names),
        device_mesh=xbuf.device_mesh, redistribute_inputs=True)(xbuf, *ws)[0]


def capacity(spec, T: int) -> int:
    """Slots per expert for T tokens: ceil(top_k * T * capacity_factor /
    E), at least 4, rounded up to a multiple of 4."""
    c = int(math.ceil(spec.top_k * T * spec.capacity_factor / spec.num_experts))
    return max(4, c + (-c) % 4)


def aux_losses(spec, probs, ids, token_mask=None):
    """Switch-style load-balance loss: E * sum_e (share of routed slots)
    * (mean router probability).  ``token_mask`` (T,) excludes pad
    tokens from both statistics."""
    T, E = probs.shape
    assign = torch.nn.functional.one_hot(ids.long(), E).to(torch.float32).sum(1)
    if token_mask is None:
        frac_tokens = assign.mean(0) / spec.top_k
        frac_probs = probs.mean(0)
    else:
        w = token_mask.to(torch.float32)[:, None]  # (T, 1)
        n = torch.clamp(w.sum(), min=1.0)
        frac_tokens = (assign * w).sum(0) / (n * spec.top_k)
        frac_probs = (probs * w).sum(0) / n
    return {"load_balance": E * torch.sum(frac_tokens * frac_probs)}


def moe_apply_dense(p, cfg, x2d):
    """Oracle: every expert computed for every token, combined with the
    (sparse) routing weights.  Returns (y2d, aux)."""
    spec = cfg.moe
    w, ids, probs = route_topk(p, spec, x2d)
    T, D = x2d.shape
    E = spec.num_experts
    wdense = torch.zeros((T, E), dtype=torch.float32, device=x2d.device
                         ).scatter_add(1, ids.long(), w)
    y_all = expert_ffn(p["experts"], cfg, x2d[None].expand(E, T, D))
    y = torch.einsum("etd,te->td", y_all.to(torch.float32), wdense)
    return y.to(x2d.dtype), aux_losses(spec, probs, ids)


def dispatch_maps(ids, w, mask, num_experts: int, cap: int):
    """The dispatch plan of g independent groups: ids (g, Tg, K), w (g,
    Tg, K) routing weights, mask (g, Tg) bool (False: a pad token, sent
    to the virtual expert E so that it never claims a slot).  Slots are
    claimed token-major (token t's k-th expert before token t+1's) and a
    slot past ``cap`` is dropped.  Returns ``(slot, tok_map, w_map)``:
    slot (g, Tg*K) the flat index of each (token, k) into its group's
    (E, cap + 1) slots (index cap of an expert is the bin of dropped
    pairs); tok_map (g, E, cap) int32 the token of each slot (Tg = empty)
    and w_map (g, E, cap) its routing weight (0 = empty), differentiable
    in ``w``."""
    g, Tg, K = ids.shape
    E, dev = num_experts, ids.device
    flat_e = ids.reshape(g, Tg * K).long()
    valid = mask.repeat_interleave(K, dim=1)
    flat_e = torch.where(valid, flat_e, torch.full_like(flat_e, E))
    onehot = torch.nn.functional.one_hot(flat_e, E + 1)[..., :E]
    pos_in_e = onehot.cumsum(1) - onehot
    pos = pos_in_e.gather(2, flat_e.clamp(max=E - 1)[..., None])[..., 0]
    keep = (pos < cap) & valid
    slot = flat_e.clamp(max=E - 1) * (cap + 1) + torch.where(
        keep, pos, torch.full_like(pos, cap))
    n = E * (cap + 1)
    flat = (slot + torch.arange(g, device=dev)[:, None] * n).reshape(-1)
    tok = torch.arange(Tg, device=dev).repeat_interleave(K).expand(g, -1)
    # kept pairs own distinct slots; dropped ones all land in their
    # expert's bin, whose contents are cut away (no host sync anywhere)
    tok_map = torch.full((g * n,), Tg, dtype=torch.int32, device=dev).scatter(
        0, flat, torch.where(keep, tok, Tg).reshape(-1).to(torch.int32))
    w_map = torch.zeros((g * n,), dtype=w.dtype, device=dev).index_add(
        0, flat, w.reshape(-1))
    cut = lambda t: t.reshape(g, E, cap + 1)[:, :, :cap]
    return slot, cut(tok_map), cut(w_map)


def moe_apply_dispatch(p, cfg, x2d, capacity_factor=None, groups=None,
                       token_mask=None):
    """Scatter-dispatch MoE (the training forward): tokens are scattered
    into an (E, capacity, D) buffer per group (:func:`dispatch_maps`;
    masked and overflow pairs dropped), the expert FFNs run batched over
    the buffer (:func:`expert_ffn`), and each slot's output, times its
    routing weight, is added back to its token.  ``groups`` (default
    ``cfg.moe_dispatch_groups``; 1 where it does not divide T) dispatches
    that many equal token groups independently, each with its own
    capacity.  Gradients flow through the gathered rows, the routing
    weights and the router probabilities of the load-balance loss.
    Returns ``(y2d, {"load_balance"})``."""
    spec = cfg.moe
    if capacity_factor is not None:
        spec = dataclasses.replace(spec, capacity_factor=capacity_factor)
    g = groups or getattr(cfg, "moe_dispatch_groups", 1) or 1
    T, D = x2d.shape
    if T % g:
        g = 1
    w, ids, probs = route_topk(p, spec, x2d)
    Tg, E, K = T // g, spec.num_experts, spec.top_k
    C = capacity(spec, Tg)
    mask = (torch.ones((g, Tg), dtype=torch.bool, device=x2d.device)
            if token_mask is None else token_mask.reshape(g, Tg).bool())
    # on a mesh each rank dispatches its own groups (group axis -> batch
    # shards); the expert axis -> "model" (expert parallel) when divisible
    grp = ("pod", "data")
    buf, tok_map, w_map = run_local(
        lambda xg, i, wg, m: _dispatch(xg, i, wg, m, E, C),
        (x2d.reshape(g, Tg, D), ids.reshape(g, Tg, K), w.reshape(g, Tg, K),
         mask), ((grp,),) * 4,
        lambda mesh: (spec_placements(mesh, (g,), (grp,)),) * 3)
    buf = constrain(buf, grp, "model", None, None)
    ybuf = expert_ffn(p["experts"], cfg, buf)                # (g, E, C, D)
    ybuf = constrain(ybuf, grp, "model", None, None)
    # the combine scatters straight from the expert-sharded ybuf into
    # per-token partial sums: the cross-shard traffic is (Tg, D), not
    # (E, C, D)
    y = run_local(lambda yb, tm, wm: _combine(yb, tm, wm, Tg, x2d.dtype
                                              ).reshape(-1, D),
                  (ybuf, tok_map, w_map), ((grp, "model"),) * 3,
                  lambda mesh: _partial_over_experts(
                      mesh, (g,), E % mesh_axis_size(mesh, "model") == 0))
    return y, aux_losses(spec, probs, ids, token_mask=token_mask)


def _dispatch(xg, ids, w, mask, E: int, C: int):
    """Groups xg (g, Tg, D) into per-expert capacity buffers (g, E, C, D)
    by :func:`dispatch_maps`; returns (buf, tok_map, w_map)."""
    g, Tg, D = xg.shape
    K = ids.shape[-1]
    slot, tok_map, w_map = dispatch_maps(ids, w, mask, E, C)
    xslot = xg[:, torch.arange(Tg, device=xg.device).repeat_interleave(K)]
    n = E * (C + 1)
    flat = (slot + torch.arange(g, device=xg.device)[:, None] * n).reshape(-1)
    buf = torch.zeros((g * n, D), dtype=xg.dtype, device=xg.device
                      ).index_add(0, flat, xslot.reshape(-1, D))
    return buf.reshape(g, E, C + 1, D)[:, :, :C], tok_map, w_map


def _combine(ybuf, tok_map, w_map, Tg: int, dtype):
    """Each slot's output of ybuf (g, E, C, D) times its routing weight,
    added back to its token (``tok_map``; Tg = empty): (g, Tg, D)."""
    g, D = ybuf.shape[0], ybuf.shape[-1]
    contrib = ybuf * w_map[..., None].to(ybuf.dtype)
    dst = (tok_map.long() + torch.arange(g, device=ybuf.device)[:, None, None]
           * (Tg + 1)).reshape(-1)
    y = torch.zeros((g * (Tg + 1), D), dtype=dtype, device=ybuf.device
                    ).index_add(0, dst, contrib.reshape(-1, D).to(dtype))
    return y.reshape(g, Tg + 1, D)[:, :Tg]


def _partial_over_experts(mesh, shape, split: bool):
    """Placements of a per-token output of the experts: batch entries of
    ``shape[0]`` as the batch axes allow, and partial sums over
    ``"model"`` where the experts' work is split on it (``split``)."""
    from torch.distributed.tensor import Partial

    pl = list(spec_placements(mesh, shape, (("pod", "data"),)))
    if split and "model" in mesh_names(mesh):
        pl[mesh_names(mesh).index("model")] = Partial()
    return tuple(pl)


GATHER_BYTES = 1 << 30  # per-(token, k) weights one gather block copies


def moe_apply_gather(p, cfg, x2d):
    """Per-token expert-weight gather over the dense ``p["experts"]``
    stack (the plain plane's MoE).  Each row's (token, k) weights are
    gathered for the gather einsums, in blocks of rows that copy at most
    ``GATHER_BYTES``: the same einsums over fewer rows at a time, where a
    Mixtral-width prompt chunk gathered whole would copy ~0.7 GB per row.
    On a mesh each rank gathers from its own shard of the stack (its
    experts, or its slice of every expert's hidden dim) and leaves
    partial sums over ``"model"``."""
    w, ids, probs = route_topk(p, cfg.moe, x2d)
    ex = p["experts"]
    E = cfg.moe.num_experts

    def local(x, i, wt, wg, wu, wd):
        e_off = 0
        if wg.shape[0] < E:  # expert parallel: this rank's experts only
            e_off = shard_offset(ex["w_gate"], 0)[0]
        return _gather_experts(cfg, x, i, wt, wg, wu, wd, e_off)

    def out_pl(mesh):
        split = E % mesh_axis_size(mesh, "model") == 0 or \
            cfg.d_ff % mesh_axis_size(mesh, "model") == 0
        return _partial_over_experts(mesh, tuple(x2d.shape), split)

    ep = E % max(1, _model_size()) == 0
    wspec = ("model", None, None) if ep else (None, None, "model")
    dspec = ("model", None, None) if ep else (None, "model", None)
    y = run_local(local, (x2d, ids, w, ex["w_gate"], ex["w_up"],
                          ex["w_down"]),
                  ((("pod", "data"),),) * 3 + (wspec, wspec, dspec), out_pl)
    return y, {"ids": ids, "weights": w, "probs": probs}


def _model_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh_axis_size(mesh, "model")


def _gather_experts(cfg, x2d, ids, w, w_gate, w_up, w_down, e_off: int = 0):
    """:func:`moe_apply_gather`'s FFN over the stack (E', D, F'); ids
    index it from ``e_off`` (pairs routed outside it weigh 0)."""
    idx = ids.to(torch.long)
    if e_off or w_gate.shape[0] < cfg.moe.num_experts:
        idx = idx - e_off
        own = (idx >= 0) & (idx < w_gate.shape[0])
        w = torch.where(own, w, torch.zeros_like(w))
        idx = idx.clamp(0, w_gate.shape[0] - 1)
    T, K = ids.shape
    per_row = K * sum(a[0].numel() * a.element_size()
                      for a in (w_gate, w_up, w_down))
    step = max(1, GATHER_BYTES // per_row)
    return torch.cat([_gather_ffn(cfg, x2d[a: a + step],
                                  w_gate[idx[a: a + step]],
                                  w_up[idx[a: a + step]],
                                  w_down[idx[a: a + step]], w[a: a + step])
                      for a in range(0, T, step)])


def _gather_ffn(cfg, x2d, wg, wu, wd, w):
    """The gather einsums over per-(token, k) dense weights wg/wu (T, K,
    D, F) and wd (T, K, F, D) in the model dtype."""
    g = torch.einsum("td,tkdf->tkf", x2d, wg)
    u = torch.einsum("td,tkdf->tkf", x2d, wu)
    h = _act(cfg)(g.to(torch.float32)).to(x2d.dtype) * u
    yk = torch.einsum("tkf,tkfd->tkd", h, wd)
    y = torch.einsum("tkd,tk->td", yk.to(torch.float32), w)
    return y.to(x2d.dtype)


# ----------------------------------------------------------------------
def _expert_ffn(cfg, xk, mats: EP.PackedExperts, slots=None, offsets=None):
    """xk through the packed experts of the (S, ...) tier ``mats``: (B, M,
    D) rows, row b reading slot ``slots[b]``; or, with the host row
    ``offsets`` of U ragged groups, (R, D) rows sorted by group, group u
    reading slot u.  Returns float32 in xk's shape."""
    if offsets is not None:
        mm = lambda x, qt: ops.dequant_matmul_batched(x, qt, offsets)
    else:
        mm = lambda x, qt: ops.dequant_matmul_slots(x, qt, slots)
    dt = xk.dtype
    g = mm(xk, mats.w_gate).to(dt)
    u = mm(xk, mats.w_up).to(dt)
    h = _act(cfg)(g.to(torch.float32)).to(dt) * u
    return mm(h, mats.w_down)


def _packed_compute(cfg, x2d, mats: EP.PackedExperts, slots, w, *,
                    fused: bool = True, vectorized: bool = True):
    """Every (token, k) expert matmul of a decode batch from the packed
    tier ``mats`` at ``slots`` (T*K,): with ``fused``, straight from the
    packed records, one kernel launch per matrix for the whole batch
    (``vectorized``) or three 2-D launches per (token, k) pair (the
    reference's unrolled branch, over records 0.. of the serve tier);
    without it, each served record dequantized into the model dtype and
    the gather einsums."""
    T, K = w.shape
    dt = x2d.dtype
    if not fused:
        deq = lambda qt: hqq.dequantize(ref.gather_slots(qt, slots), dt
                                        ).reshape((T, K) + tuple(qt.shape[1:]))
        return _gather_ffn(cfg, x2d, deq(mats.w_gate), deq(mats.w_up),
                           deq(mats.w_down), w)
    if vectorized:
        xk = x2d.repeat_interleave(K, dim=0)[:, None, :]  # (T*K, 1, D)
        yk = _expert_ffn(cfg, xk, mats, slots)            # (T*K, 1, D) f32
        yk = yk.reshape(T, K, -1)
    else:
        rows = []
        for t in range(T):
            xt = x2d[t:t + 1]
            for k in range(K):
                sl = mats.slice(t * K + k)
                g = ops.dequant_matmul(xt, sl.w_gate).to(dt)
                u = ops.dequant_matmul(xt, sl.w_up).to(dt)
                h = _act(cfg)(g.to(torch.float32)).to(dt) * u
                rows.append(ops.dequant_matmul(h, sl.w_down))
        yk = torch.stack(rows).reshape(T, K, -1)          # (T, K, D) f32
    y = torch.einsum("tkd,tk->td", yk, w)
    return y.to(dt)


def moe_apply_packed_stream(p, cfg, x2d, store: EP.Tier, l: int,
                            tier: EP.PrefillTier, *, fused: bool = True):
    """Prefill-chunk MoE over the packed host store: route, read the ids
    to the host (one read), copy each distinct routed expert once into
    ``tier``, gather the (token, k) rows sorted by expert into ragged
    groups (no padding) and run the grouped kernel over the tier
    (``fused``), or dequantize the U experts into the model dtype and run
    one plain product per group (``fused=False``); the outputs return to
    (token, k) order by the inverse permutation.  The order, its inverse
    and the group offsets come from the counts already on the host; one
    upload carries the two permutations.  No pool state is read or
    written and no offload counter moves.  Returns ``(y2d,
    route_info)``."""
    w, ids, probs = route_topk(p, cfg.moe, x2d)
    T, K = ids.shape
    flat = EP.read_host(tier, ids.reshape(-1)).astype(np.int64)
    experts, group = np.unique(flat, return_inverse=True)  # row -> group
    order = np.argsort(group, kind="stable")  # routed rows, grouped by expert
    counts = np.bincount(group, minlength=len(experts))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order))
    mats = tier.load(store, l, experts)
    R = len(flat)
    idx = torch.as_tensor(np.concatenate([order // K, inverse]),
                          device=x2d.device)
    tier.batches.append(tuple(int(c) for c in counts))
    xs = x2d[idx[:R]]                                   # (R, D) by expert
    if fused:
        ys = _expert_ffn(cfg, xs, mats, offsets=offsets)  # (R, D) f32
    else:
        dt = x2d.dtype
        wg, wu, wd = (hqq.dequantize(qt, dt) for qt in mats)
        spans = list(zip(offsets[:-1], offsets[1:]))
        mm = lambda a, wt: torch.cat([a[o0:o1] @ wt[u]
                                      for u, (o0, o1) in enumerate(spans)])
        h = _act(cfg)(mm(xs, wg).to(torch.float32)).to(dt) * mm(xs, wu)
        ys = mm(h, wd).to(torch.float32)
    yk = ys[idx[R:]].reshape(T, K, -1)
    y = torch.einsum("tkd,tk->td", yk, w).to(x2d.dtype)
    return y, {"ids": ids, "ids_host": flat.reshape(T, K), "weights": w,
               "probs": probs}


def moe_apply_packed(p, cfg, x2d, store: EP.Tier, pstate: EP.PoolState,
                     l: int, routers=None, *, lookahead: int = 1,
                     n_spec: int = 0, active: Optional[np.ndarray] = None,
                     rows_dev: Optional[torch.Tensor] = None,
                     fused: bool = True, vectorized: bool = True,
                     overlap: bool = True, mark=None):
    """Offloaded-decode MoE of MoE layer ``l`` over T token rows.

    Routes, and (a single row with ``n_spec > 0`` and ``routers``)
    predicts the lookahead layer's experts from the same hidden state;
    both id sets reach the host in ONE read, the layer's only
    synchronisation.  ``acquire`` then performs the pool swaps and the
    kernel reads the pool and its overflow records in place.  With
    ``overlap`` (the pipelined plane) the lookahead layer's staging is
    issued before the expert compute, on the side copy stream, so that it
    overlaps that compute; without it, after the compute on the compute
    stream (the reference's staging inside the block).  ``fused`` and
    ``vectorized`` select the compute and data plane
    (:func:`_packed_compute`, ``expert_pool.acquire``).

    ``active`` (T,) bool marks the rows whose output is used (the busy
    slots of a continuous batch); the others bypass the pool and get a
    zero output: no copy, no kernel row.  ``rows_dev`` is the device copy
    of their indices when the caller has uploaded it already.  ``mark``,
    the telemetry's phase observer, times the overlapped staging apart:
    ``mark("moe")`` before it is issued, ``mark("stage")`` after.  Returns
    ``(y2d, route_info, pstate)``; ``route_info["ids"]`` is the host copy
    of every row's routed ids.
    """
    w, ids, probs = route_topk(p, cfg.moe, x2d)
    T, K = ids.shape
    L = store.n_layers
    tgt = l + lookahead
    speculate = T == 1 and n_spec > 0 and routers is not None and tgt < L
    read = ids.reshape(-1)
    if speculate:
        pred = speculative.predict_experts(routers[tgt], x2d, n_spec)[0]
        read = torch.cat([read, pred])
    host = EP.read_host(pstate, read)
    ids_h = host[: T * K].reshape(T, K)
    slots = EP.acquire(store, pstate, l, ids_h, active, vectorized=vectorized)
    stage = lambda: EP.stage(store, pstate, tgt, host[T * K:],
                             vectorized=vectorized, overlap=overlap)
    if speculate and overlap:
        if mark is not None:
            mark("moe")
        stage()
        if mark is not None:
            mark("stage")
    mats = EP.served(pstate, l, vectorized)
    kw = dict(fused=fused, vectorized=vectorized)
    if active is None or active.all():
        y = _packed_compute(cfg, x2d, mats, slots, w, **kw)
    else:
        y = torch.zeros_like(x2d)
        if active.any():
            if rows_dev is None:
                rows_dev = torch.as_tensor(np.flatnonzero(active),
                                           device=x2d.device)
            y[rows_dev] = _packed_compute(cfg, x2d[rows_dev], mats, slots,
                                          w[rows_dev], **kw)
    if speculate and not overlap:
        stage()
    return y, {"ids": ids_h, "weights": w, "probs": probs}, pstate
