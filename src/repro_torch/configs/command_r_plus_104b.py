"""Command R+ (104B) — large dense decoder, GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01 (family card; plus-size dims per brief)]
64L, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    block_pattern=("attn+mlp",),
    mlp_act="swiglu",
    norm="layernorm",
    rope_theta=75000000.0,
    tie_embeddings=True,
    citation="hf:CohereForAI/c4ai-command-r-v01",
)
