"""Plain reference of the benchmark's MoE decoders (Mixtral, Granite MoE).

A pre-norm decoder: RMS norm, grouped-query causal attention with rotary
positions (interleaved pairs) and an optional sliding window, then a
top-k softmax router (weights renormalised over the k chosen, Mixtral's
rule) over SwiGLU experts, a final RMS norm and the output head (the
embedding's transpose where tied).  It follows the program's model and
departs from the published models where the program does: Granite's
embedding, attention, residual and logit multipliers are absent (the
configuration file lists them as changed).

Float32 throughout, TF32 off, no cache, no kernel: the full forward pass
over each whole sequence, one layer at a time over all sequences so that
only one layer's experts are ever held.  The raw weights are drawn again
from the run's seed (``portbench.weights``), and what the program's
set-up derives from them is worked out again by the frozen HQQ copy
(``reference/hqq.py``): each layer's experts quantized at
``expert_bits`` and back, and the attention projections, which the
program quantizes at ``attn_bits`` as matrices over the stacked layers,
quantized the same way.

``precision="fp8"`` is the control: every matrix product's operands
rounded to float8 e4m3 (per-tensor scales for weights, per-row for
activations), the step below the served bfloat16 that a later change
could be tempted to take.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from portbench import weights as W
from portbench.reference import hqq as RH

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a scale per tensor (``dim``
    None) or per slice along ``dim``."""
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True)).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, x, w):
        """x (..., K) @ w (K, N) in float32, operands rounded in fp8 mode."""
        if self.low:
            x, w = _fp8(x, dim=-1), _fp8(w)
        return x @ w

    def act(self, t):
        return _fp8(t, dim=-1) if self.low else t


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """x (S, H, hd) at positions ``pos`` (S,), interleaved pairs."""
    hd = x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device),
                          torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.to(torch.float32)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)


def _attention(ops, x, wq, wk, wv, wo, cfg, q_block=1024):
    """Causal GQA over one sequence x (S, D), ``q_block`` queries at a
    time (the scores of a long prompt would not fit at once)."""
    S, D = x.shape
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    pos = torch.arange(S, device=x.device)
    q = _rope(ops.mm(x, wq.reshape(D, -1)).reshape(S, H, hd), pos, cfg["rope_theta"])
    k = _rope(ops.mm(x, wk.reshape(D, -1)).reshape(S, Hkv, hd), pos, cfg["rope_theta"])
    v = ops.mm(x, wv.reshape(D, -1)).reshape(S, Hkv, hd)
    q, k, v = ops.act(q), ops.act(k), ops.act(v)
    g = H // Hkv
    qh = q.reshape(S, Hkv, g, hd).permute(1, 2, 0, 3)        # (Hkv, g, S, hd)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)          # (Hkv, S, hd)
    outs = []
    for a in range(0, S, q_block):
        qp = pos[a: a + q_block]
        s = torch.einsum("hgqd,hkd->hgqk", qh[:, :, a: a + q_block], kh) / math.sqrt(hd)
        valid = pos[None, :] <= qp[:, None]
        if cfg.get("sliding_window"):
            valid = valid & (qp[:, None] - pos[None, :] < cfg["sliding_window"])
        s = torch.where(valid, s, torch.full_like(s, -math.inf))
        outs.append(torch.einsum("hgqk,hkd->hgqd", torch.softmax(s, dim=-1), vh))
    o = torch.cat(outs, dim=2).permute(2, 0, 1, 3).reshape(S, H * hd)
    return ops.mm(o, wo.reshape(H * hd, D))


def _moe(ops, x, router, experts, cfg):
    """x (T, D) through the top-k routed experts of one layer."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(ops.mm(x, router), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros_like(x)
    for e in range(router.shape[1]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = torch.nn.functional.silu(ops.mm(xe, experts["w_gate"][e])) \
            * ops.mm(xe, experts["w_up"][e])
        y.index_add_(0, rows, w[rows, slot][:, None] * ops.mm(h, experts["w_down"][e]))
    return y


def layer_experts(cfg: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s experts as the program serves them, float32 (E, K,
    N): the raw stacks through the frozen quantizer at ``expert_bits``."""
    bits = cfg["offload"]["expert_bits"]
    return {m: RH.quantize_dequantize(w, bits)
            for m, w in W.experts(cfg, seed, layer, device).items()}


def shared_weights(cfg: dict, p: dict) -> dict:
    """The program's attention projections, (L, ...) in the served type:
    each of ``wq``/``wk``/``wv`` quantized at ``attn_bits`` as one (L, D *
    heads * hd) matrix and ``wo`` as one (L * H * hd, D) matrix, and back;
    a matrix whose row count the group size does not divide stays as
    drawn (the program's rule)."""
    bits = cfg["offload"]["attn_bits"]
    gs = RH.SCHEMES[bits]["group_size"]
    out = {}
    for name in ("wq", "wk", "wv", "wo"):
        w = p[name]
        mat = w.reshape(-1, w.shape[-1]) if name == "wo" else w.reshape(w.shape[0], -1)
        out[name] = (w if mat.shape[0] % gs else
                     RH.quantize_dequantize(mat, bits).to(w.dtype).reshape(w.shape))
    return out


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs: Sequence[Sequence[int]], starts:
           Sequence[int], device, precision: str = "f32") -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]``, the float32 logits over the
    real vocabulary at positions ``starts[i] - 1 .. len - 2`` (those that
    predict tokens ``starts[i] ..``): (len - starts[i], V) each."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, seed, seqs, starts, torch.device(device),
                       _Ops(precision))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _logits(cfg, seed, seqs, starts, dev, ops):
    p = W.dense(cfg, seed, dev)
    L, V, eps = cfg["num_hidden_layers"], cfg["vocab_size"], cfg["rms_norm_eps"]
    f = lambda t: t.to(torch.float32)
    p.update(shared_weights(cfg, p))
    lens = [len(s) for s in seqs]
    ids = torch.as_tensor([t for s in seqs for t in s], dtype=torch.long, device=dev)
    x = f(p["embed"][ids])
    cuts = [0]
    for n in lens:
        cuts.append(cuts[-1] + n)
    for l in range(L):
        h = _rms(x, f(p["norms"][2 * l]), eps)
        att = torch.cat([_attention(ops, h[a:b], f(p["wq"][l]), f(p["wk"][l]),
                                    f(p["wv"][l]), f(p["wo"][l]), cfg)
                         for a, b in zip(cuts[:-1], cuts[1:])])
        x = x + att
        experts = layer_experts(cfg, seed, l, dev)
        x = x + _moe(ops, _rms(x, f(p["norms"][2 * l + 1]), eps),
                     p["router"][l], experts, cfg)
        del experts
    pick = torch.cat([torch.arange(a + s - 1, b - 1, device=dev)
                      for a, b, s in zip(cuts[:-1], cuts[1:], starts)])
    xf = _rms(x[pick], f(p["norms"][2 * L]), eps)
    head = (f(p["embed"][:V]).t() if cfg["tie_word_embeddings"]
            else f(p["lm_head"][:, :V]))
    out = ops.mm(xf, head)
    return list(torch.split(out, [n - s for n, s in zip(lens, starts)]))
