"""SmolLM-360M — llama-style small dense decoder.

[hf:HuggingFaceTB/SmolLM-360M (family card hf:HuggingFaceTB/SmolLM-135M)]
32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152, tied embeds.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=("attn+mlp",),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)
