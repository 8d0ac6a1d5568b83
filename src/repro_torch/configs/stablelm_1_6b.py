"""StableLM-2 1.6B — dense decoder, MHA, partial rotary (25%), LayerNorm.

[hf:stabilityai/stablelm-2-1_6b]
24L, d_model=2048, 32 heads (kv=32), d_ff=5632, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    block_pattern=("attn+mlp",),
    qkv_bias=False,
    mlp_act="swiglu",
    norm="layernorm",
    rope_theta=10000.0,
    rope_fraction=0.25,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
