"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
24L, d_model=1024, 16 heads (GQA kv=8), expert d_ff=512, vocab=49155,
MoE 32 experts top-8.  Full paper-technique target (offload spec attached).
"""
from repro_torch.configs.base import ModelConfig, MoESpec, OffloadSpec

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("attn+moe",),
    moe=MoESpec(num_experts=32, top_k=8),
    offload=OffloadSpec(cache_size=8, num_speculative=4, expert_bits=3),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
