"""The model's raw weights, drawn from the run's seed on the device.

Both sides get the same numbers: the harness hands them to the program,
whose set-up derives what it serves from them (the HQQ-packed experts,
the 4-bit attention output projections), and the plain reference draws
them again from the same seed after the program's state is freed and
works the derived weights out again itself.  Every weight is drawn in
the type a checkpoint holds it in (the configuration's ``torch_dtype``;
the router in float32, as the program keeps it), in a few large calls:
the dense weights of all layers from one generator, each layer's three
expert stacks from a generator of its own, so that the program's set-up
and the reference can each take one layer at a time.

The scales are chosen so that the random model is well conditioned and
its greedy output does not collapse.  Drawn at the usual scales, every
position attends nearly uniformly, so the residual stream is nearly the
same at every position and greedy decoding repeats one token; a tied
head (Granite) predicts the current token, or a two-cycle, whenever the
embedding dominates the stream; and where expert outputs dominate it, a
routing choice that a rounding flips changes the logits by a whole
expert's share, so bfloat16 and float32 part by as much as float8 does
and no limit could tell a sound program from a coarser one.  Hence the
first layer's attention maps each token to a large feature of its own,
the experts' updates are small, and attention elsewhere is soft (the
usual scales), so that a fault in the KV state still moves the logits.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

# The experts write a small update into the residual stream: their down
# projections are drawn at MOE_GAIN x the usual 1/sqrt(f)/sqrt(2L).
MOE_GAIN = 0.3
# The first layer's attention attends to each position's own token: its
# query and key projections are equal (each query head that of its key
# head), drawn 1.5x the 1/sqrt(d) scale, so that a token's own score
# leads every other by a wide margin; its output projection is drawn at
# 1/sqrt(heads * head_dim).  The residual stream is then dominated from
# the first layer on by a fixed linear map of the token's embedding.
SELF_GAIN = 1.5
EXPERT_MATS = ("w_gate", "w_up", "w_down")


def mix(seed: int, k: int) -> int:
    """A generator seed for stream ``k`` of run seed ``seed`` (any int)."""
    return (int(seed) * 1_000_003 + k * 7_919 + 1) % (2 ** 63)


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def _randn(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def dense(cfg: dict, seed: int, device) -> dict:
    """Every weight but the experts, stacked over layers: ``embed``
    (Vp, D), ``lm_head`` (D, Vp) unless tied, ``norms`` (2L + 1, D) (each
    layer's pre-attention and pre-MoE scales, then the final one),
    ``wq`` (L, D, H, hd), ``wk``/``wv`` (L, D, Hkv, hd), ``wo`` (L, H, hd,
    D) in the checkpoint's type, ``router`` (L, D, E) float32."""
    dev = torch.device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(mix(seed, 0))
    dt = getattr(torch, cfg["torch_dtype"])
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    Vp, E = padded_vocab(cfg["vocab_size"]), cfg["num_local_experts"]
    sc = 1.0 / math.sqrt(D)
    out = {"embed": _randn(gen, (Vp, D), sc, dt)}
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = _randn(gen, (D, Vp), sc, dt)
    out["norms"] = (1.0 + 0.1 * torch.randn((2 * L + 1, D), generator=gen,
                                            device=dev)).to(dt)
    out["wq"] = _randn(gen, (L, D, H, hd), sc, dt)
    out["wk"] = _randn(gen, (L, D, Hkv, hd), sc, dt)
    out["wv"] = _randn(gen, (L, D, Hkv, hd), sc, dt)
    out["wo"] = _randn(gen, (L, H, hd, D), sc / math.sqrt(2 * L), dt)
    k0 = _randn(gen, (D, Hkv, hd), SELF_GAIN * sc, dt)
    out["wk"][0] = k0
    out["wq"][0] = k0.repeat_interleave(H // Hkv, dim=1)
    out["wo"][0] = _randn(gen, (H, hd, D), 1.0 / math.sqrt(H * hd), dt)
    out["router"] = torch.randn((L, D, E), generator=gen, device=dev) * sc
    return out


def expert_std(cfg: dict, mat: str) -> float:
    D, F, L = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    if mat == "w_down":
        return MOE_GAIN / math.sqrt(F) / math.sqrt(2 * L)
    return 1.0 / math.sqrt(D)


def experts(cfg: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s raw expert stacks in the checkpoint's type:
    ``w_gate``, ``w_up`` (E, D, F) and ``w_down`` (E, F, D), one call
    each."""
    dev = torch.device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(mix(seed, 1 + layer))
    dt = getattr(torch, cfg["torch_dtype"])
    E, D, F = (cfg["num_local_experts"], cfg["hidden_size"],
               cfg["intermediate_size"])
    shapes = {"w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D)}
    return {m: _randn(gen, shapes[m], expert_std(cfg, m), dt)
            for m in EXPERT_MATS}
