"""Tiny dense draft model for token-level speculative decoding.

Shares the tiny-moe tokenizer/vocab (byte-level, 512 entries) but is a
plain dense transformer at a fraction of the size: the draft proposes
greedy continuations that the expensive offloaded MoE target verifies in
one packed C=k chunk (DESIGN.md §11).  Dense on purpose — a draft with
its own expert streaming would compete with the target for the h2d bus,
which is exactly the resource speculation is trying to amortize.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tiny-draft",
    arch_type="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,  # MUST match tiny-moe (draft/target share tokens)
    block_pattern=("attn+mlp",),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="float32",
    citation="in-repo draft proxy for arXiv:2312.17238 token speculation",
)
