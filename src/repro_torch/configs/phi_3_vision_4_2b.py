"""Phi-3-vision 4.2B — phi3-mini LM backbone + CLIP vision stub.

[hf:microsoft/Phi-3-vision-128k-instruct]
32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.  The vision
tower (CLIP ViT-L + projector) is a STUB: ``input_specs`` provides
precomputed patch embeddings (num_image_tokens positions at sequence start).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    block_pattern=("attn+mlp",),
    num_image_tokens=576,  # one CLIP-L 336px tile worth of patches
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)
