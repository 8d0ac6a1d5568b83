"""Recurrent sequence mixers: RG-LRU (Griffin / RecurrentGemma), mLSTM and
sLSTM (xLSTM).  Port of the reference's ``models/recurrent.py``, with its
names, so that each function's counterpart is found by name.

Each mixer has the same entry points:

* ``*_train(p, cfg, x)``: the whole sequence from a zero state, under
  autograd; returns ``(y, final_state)``;
* ``*_decode(p, cfg, x_t, state)``: one step; returns ``(y_t, state)``;
* ``*_chunk(p, cfg, x, state)``: C tokens from a carried state, folded
  step by step (the decode update), so that a C = 1 chunk is the decode
  step and chunk boundaries do not move the carry;
* ``init_*_state(cfg, batch, device)``: the zero state.

Carries are float32; the RG-LRU's conv prefix is in the parameter dtype.
Plain PyTorch: the reference computes all three in plain ``jnp`` (no
Pallas kernel), and the recurrences here are Python loops of small
launches (sLSTM, the step forms) or a log2(S)-step doubling scan (the
RG-LRU's training form).

* The mLSTM's training form is chunkwise-parallel (:func:`mlstm_scan_core`):
  matmuls within a chunk of ``cfg.mlstm_chunk`` positions, a loop across
  chunks, with the same stabilisers as the step-by-step oracle
  :func:`mlstm_recurrent_ref` (every exponent <= 0).
* The RG-LRU's training form scans ``h_t = a_t h_{t-1} + b_t`` by
  doubling (Hillis-Steele) with the reference's combine ``(a1 a2, a2 b1 +
  b2)``: the products are grouped otherwise than in the reference's
  ``associative_scan`` or in the step form, so the three agree within
  float32 rounding, not bit for bit.
* ``jax.nn.gelu`` is the tanh form (``approximate="tanh"`` here), and
  ``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x (torch's
  ``softplus`` turns into the identity above its threshold).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dt as _pdt
from repro_torch.models.layers import _mm, _project, _randn
from repro_torch.sharding.specs import constrain, is_dtensor

F32 = torch.float32


def _heads(x, w, eq="bsd,dhj->bshj"):
    """x (B, S, D) projected by w (D, *heads): the einsum ``eq``; on a
    DTensor weight the sharded projection (``layers._project``)."""
    return _project(x, w) if is_dtensor(w) else torch.einsum(eq, x, w)


def _logsigmoid(x):
    """log sigmoid(x); on a DTensor -softplus(-x), whose backward DTensor
    can shard (``log_sigmoid_backward`` has no sharding rule)."""
    return -_softplus(-x) if is_dtensor(x) else F.logsigmoid(x)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


# ======================================================================
# RG-LRU block (Griffin's recurrent block: gate branch * conv -> RG-LRU)
RGLRU_C = 8.0


def init_rglru(gen, cfg):
    D = R = cfg.d_model  # rnn width = d_model (4096 in RecurrentGemma-9B)
    dt, dev = _pdt(cfg), gen.device
    sc, scr = 1.0 / math.sqrt(D), 1.0 / math.sqrt(R)
    # lam such that a = exp(-c softplus(lam)) lies in (0.9, 0.999)
    lam = torch.rand((R,), generator=gen, device=dev) * 4.7 - 9.0
    return {
        "w_x": _randn(gen, (D, R), sc, dt),
        "w_gate_br": _randn(gen, (D, R), sc, dt),
        "conv_w": _randn(gen, (cfg.rglru_conv_width, R), 0.1, dt),
        "conv_b": torch.zeros((R,), dtype=dt, device=dev),
        "w_rec_gate": _randn(gen, (R, R), scr, dt),
        "w_in_gate": _randn(gen, (R, R), scr, dt),
        "lam": lam.to(F32),
        "w_out_r": _randn(gen, (R, D), scr / math.sqrt(2 * cfg.n_layers), dt),
    }


def init_rglru_state(cfg, batch: int, device):
    R = cfg.d_model
    return {"h": torch.zeros((batch, R), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, R),
                                dtype=_pdt(cfg), device=device)}


def _causal_conv(p, x, prefix):
    """Depthwise causal conv of width cw: x (B, S, R), prefix (B, cw-1,
    R).  Returns (y, the new prefix)."""
    cw = p["conv_w"].shape[0]
    S = x.shape[1]
    xp = torch.cat([prefix, x], dim=1)
    y = sum(xp[:, i: i + S] * p["conv_w"][cw - 1 - i] for i in range(cw))
    return y + p["conv_b"], xp[:, -(cw - 1):]


def _rglru_gates(p, xi):
    r = torch.sigmoid(_mm(xi, p["w_rec_gate"]).to(F32))
    i = torch.sigmoid(_mm(xi, p["w_in_gate"]).to(F32))
    log_a = -RGLRU_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * xi.to(F32))
    return a, b


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, by doubling:
    after the step at distance d, (A_t, B_t) combines positions (t - 2d,
    t]; log2(S) steps of whole-sequence ops, autograd-friendly."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_train(p, cfg, x):
    B = x.shape[0]
    gate = _gelu(_mm(x, p["w_gate_br"]).to(F32))
    xi0 = _mm(x, p["w_x"])
    prefix = torch.zeros((B, cfg.rglru_conv_width - 1, xi0.shape[-1]),
                         dtype=x.dtype, device=x.device)
    xi, conv_state = _causal_conv(p, xi0, prefix)
    a, b = _rglru_gates(p, xi)
    # the recurrence is elementwise over R: shard R on "model" so the
    # scan's saved intermediates shard too
    a = constrain(a, ("pod", "data"), None, "model")
    b = constrain(b, ("pod", "data"), None, "model")
    h = _linear_scan(a, b)
    y = _mm((gate * h).to(x.dtype), p["w_out_r"])
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_decode(p, cfg, x_t, state):
    """x_t: (B, 1, D)."""
    gate = _gelu(_mm(x_t, p["w_gate_br"]).to(F32))
    xi, conv_state = _causal_conv(p, _mm(x_t, p["w_x"]), state["conv"])
    a, b = _rglru_gates(p, xi)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = _mm((gate * h[:, None]).to(x_t.dtype), p["w_out_r"])
    return y, {"h": h, "conv": conv_state}


def rglru_chunk(p, cfg, x, state):
    """C tokens from the carried state: projections, conv taps and gates
    over the whole chunk, then the decode update ``h = a_t h + b_t`` one
    position at a time."""
    gate = _gelu(_mm(x, p["w_gate_br"]).to(F32))
    xi, conv_state = _causal_conv(p, _mm(x, p["w_x"]), state["conv"])
    a, b = _rglru_gates(p, xi)
    h, hs = state["h"], []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    y = _mm((gate * torch.stack(hs, dim=1)).to(x.dtype), p["w_out_r"])
    return y, {"h": h, "conv": conv_state}


# ======================================================================
# mLSTM (xLSTM's matrix-memory cell)
def init_mlstm(gen, cfg):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    dt, dev = _pdt(cfg), gen.device
    scd = 1.0 / math.sqrt(D)
    return {
        "wq": _randn(gen, (D, H, dh), scd, dt),
        "wk": _randn(gen, (D, H, dh), scd, dt),
        "wv": _randn(gen, (D, H, dh), scd, dt),
        "wf": _randn(gen, (D, H), scd, F32),
        "bf": torch.linspace(3.0, 6.0, H, device=dev).to(F32),  # forget bias
        "wi": _randn(gen, (D, H), scd, F32),
        "bi": torch.full((H,), -3.0, dtype=F32, device=dev),
        "w_ogate": _randn(gen, (D, D), scd, dt),
        "headnorm": torch.ones((H, dh), dtype=F32, device=dev),
        "out_proj": _randn(gen, (D, D), scd / math.sqrt(2 * cfg.n_layers), dt),
    }


def init_mlstm_state(cfg, batch: int, device):
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=F32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=F32, device=device),
            "m": torch.zeros((batch, H), dtype=F32, device=device)}


def _mlstm_qkv_gates(p, cfg, xn):
    dh = cfg.d_model // cfg.n_heads
    q = _heads(xn, p["wq"]).to(F32)
    k = _heads(xn, p["wk"]).to(F32) / math.sqrt(dh)
    v = _heads(xn, p["wv"]).to(F32)
    xf = xn.to(F32)
    lf = _logsigmoid(_mm(xf, p["wf"]) + p["bf"])
    li = _mm(xf, p["wi"]) + p["bi"]
    return q, k, v, lf, li


def mlstm_scan_core(q, k, v, lf, li, state, chunk: int):
    """Chunkwise-parallel stabilised mLSTM, float32: q, k, v (B, S, H,
    dh), lf, li (B, S, H).  Returns (h (B, S, H, dh), state), equal to
    :func:`mlstm_recurrent_ref` up to rounding (the same stabilisers)."""
    B, S, H, dh = q.shape
    L = min(chunk, S)
    if S % L:
        L = S
    C, n, m = state["C"], state["n"], state["m"]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S, L):
        qc, kc, vc = q[:, c0: c0 + L], k[:, c0: c0 + L], v[:, c0: c0 + L]
        b = torch.cumsum(lf[:, c0: c0 + L], dim=1)  # inclusive log-decay
        u = li[:, c0: c0 + L] - b
        g = torch.maximum(m[:, None], torch.cummax(u, dim=1).values)
        m_j = b + g
        decay = torch.exp(m[:, None] - g)[..., None]  # (B, L, H, 1)
        inter = torch.einsum("blhk,bhkv->blhv", qc, C) * decay
        scores = torch.einsum("blhk,bshk->bhls", qc, kc)
        us = u.transpose(1, 2)  # (B, H, L) over s
        gj = g.transpose(1, 2)  # (B, H, L) over j
        Dmat = torch.exp(us[:, :, None, :] - gj[:, :, :, None])
        Dmat = torch.where(mask, Dmat, torch.zeros_like(Dmat))
        intra = torch.einsum("bhls,bshv->blhv", scores * Dmat, vc)
        n_j = n[:, None] * decay + torch.einsum("bhls,bshk->blhk", Dmat, kc)
        qn = torch.einsum("blhk,blhk->blh", qc, n_j)
        den = torch.maximum(torch.abs(qn), torch.exp(-m_j))
        hs.append((inter + intra) / den[..., None])
        # the chunk's final state: row j = L - 1 of the same quantities
        gL = g[:, -1]
        scale_prev = torch.exp(m - gL)
        w_s = torch.exp(u - gL[:, None])
        C = (C * scale_prev[..., None, None]
             + torch.einsum("blh,blhk,blhv->bhkv", w_s, kc, vc))
        n = n * scale_prev[..., None] + torch.einsum("blh,blhk->bhk", w_s, kc)
        m = b[:, -1] + gL
    return torch.cat(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_recurrent_ref(q, k, v, lf, li, state):
    """The stabilised recurrent form, step by step (float32)."""
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, lft, lit = q[:, t], k[:, t], v[:, t], lf[:, t], li[:, t]
        m_t = torch.maximum(lft + m, lit)
        fs = torch.exp(lft + m - m_t)
        is_ = torch.exp(lit - m_t)
        C = (fs[..., None, None] * C
             + is_[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
        n = fs[..., None] * n + is_[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m_t))
        hs.append(num / den[..., None])
        m = m_t
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def _headnorm(p, h):
    hf = h.to(F32)
    ms = (hf * hf).mean(-1, keepdim=True)
    return hf * torch.rsqrt(ms + 1e-6) * p["headnorm"]


def _mlstm_out(p, cfg, xn, h):
    B, S, D = xn.shape
    o = torch.sigmoid(_mm(xn, p["w_ogate"]).to(F32))
    y = (_headnorm(p, h).reshape(B, S, D) * o).to(xn.dtype)
    return _mm(y, p["out_proj"])


def mlstm_train(p, cfg, x):
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, x)
    state = init_mlstm_state(cfg, x.shape[0], x.device)
    h, state = mlstm_scan_core(q, k, v, lf, li, state, cfg.mlstm_chunk)
    return _mlstm_out(p, cfg, x, h), state


def mlstm_decode(p, cfg, x_t, state):
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, x_t)
    h, state = mlstm_recurrent_ref(q, k, v, lf, li, state)
    return _mlstm_out(p, cfg, x_t, h), state


def mlstm_chunk(p, cfg, x, state):
    """C tokens from the carried state through the step-by-step oracle
    (:func:`mlstm_decode` already loops over the positions; the
    chunkwise core regroups its stabilisers per block and would move the
    carry with the chunk boundaries)."""
    return mlstm_decode(p, cfg, x, state)


# ======================================================================
# sLSTM (xLSTM's scalar-memory cell, with hidden-to-hidden recurrence)
N_SGATES = 4  # z, i, f, o


def init_slstm(gen, cfg):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    dt, dev = _pdt(cfg), gen.device
    bias = torch.zeros((N_SGATES, H, dh), dtype=F32, device=dev)
    bias[2] = torch.linspace(3.0, 6.0, H, device=dev)[:, None]  # forget bias
    return {
        "w_gates_in": _randn(gen, (D, N_SGATES, H, dh), 1.0 / math.sqrt(D), dt),
        "r_gates": _randn(gen, (N_SGATES, H, dh, dh), 1.0 / math.sqrt(dh), dt),
        "b_gates": bias,
        "headnorm": torch.ones((H, dh), dtype=F32, device=dev),
        "out_proj": _randn(gen, (D, D),
                           1.0 / math.sqrt(D) / math.sqrt(2 * cfg.n_layers), dt),
    }


def init_slstm_state(cfg, batch: int, device):
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = lambda: torch.zeros((batch, H, dh), dtype=F32, device=device)
    return {"h": z(), "c": z(), "n": z(), "m": z()}


def _slstm_step(p, carry, pre_in):
    """pre_in: (B, 4, H, dh), one position's input contribution."""
    h, c, n, m = carry
    rec = torch.einsum("ghij,bhj->bghi", p["r_gates"].to(F32), h)
    pre = pre_in + rec + p["b_gates"][None]
    z = torch.tanh(pre[:, 0])
    li = pre[:, 1]
    lf = _logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_t = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_t)
    is_ = torch.exp(li - m_t)
    c_t = fs * c + is_ * z
    n_t = fs * n + is_
    h_t = o * c_t / torch.maximum(n_t, torch.exp(-m_t) + 1e-9)
    return (h_t, c_t, n_t, m_t), h_t


def _slstm_pre(p, x):
    return _heads(x.to(F32), p["w_gates_in"].to(F32), "bsd,dghj->bsghj")


def _slstm_scan(p, carry, pre):
    hs = []
    for t in range(pre.shape[1]):
        carry, h_t = _slstm_step(p, carry, pre[:, t])
        hs.append(h_t)
    return carry, torch.stack(hs, dim=1)


def _slstm_state(carry):
    h, c, n, m = carry
    return {"h": h, "c": c, "n": n, "m": m}


def slstm_train(p, cfg, x):
    st = init_slstm_state(cfg, x.shape[0], x.device)
    carry, hs = _slstm_scan(p, (st["h"], st["c"], st["n"], st["m"]),
                            _slstm_pre(p, x))
    return _slstm_out(p, cfg, x, hs), _slstm_state(carry)


def slstm_decode(p, cfg, x_t, state):
    carry = (state["h"], state["c"], state["n"], state["m"])
    carry, h_t = _slstm_step(p, carry, _slstm_pre(p, x_t)[:, 0])
    return _slstm_out(p, cfg, x_t, h_t[:, None]), _slstm_state(carry)


def slstm_chunk(p, cfg, x, state):
    """C tokens from the carried state: the training scan, seeded (C = 1
    is :func:`slstm_decode`)."""
    carry = (state["h"], state["c"], state["n"], state["m"])
    carry, hs = _slstm_scan(p, carry, _slstm_pre(p, x))
    return _slstm_out(p, cfg, x, hs), _slstm_state(carry)


def _slstm_out(p, cfg, x, h):
    B, S, D = x.shape
    hn = _headnorm(p, h).reshape(B, S, D)
    return _mm(hn.to(x.dtype), p["out_proj"])


# ======================================================================
# dispatch by mixer name (the block assembly's entry points)
INIT = {"rglru": init_rglru, "mlstm": init_mlstm, "slstm": init_slstm}
INIT_STATE = {"rglru": init_rglru_state, "mlstm": init_mlstm_state,
              "slstm": init_slstm_state}
TRAIN = {"rglru": rglru_train, "mlstm": mlstm_train, "slstm": slstm_train}
DECODE = {"rglru": rglru_decode, "mlstm": mlstm_decode,
          "slstm": slstm_decode}
CHUNK = {"rglru": rglru_chunk, "mlstm": mlstm_chunk, "slstm": slstm_chunk}
