"""Qwen1.5-4B — dense decoder with QKV bias, MHA.

[hf:Qwen/Qwen1.5-0.5B (family card; 4B dims per brief)]
40L, d_model=2560, 20 heads (kv=20), d_ff=6912, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    block_pattern=("attn+mlp",),
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=5000000.0,
    citation="hf:Qwen/Qwen1.5-0.5B",
)
