"""Tiny Mixtral-family MoE: SWA attention + top-2 of 8 experts at a size
that runs in seconds on a CPU (the reference's ``tiny-moe``)."""
from repro_torch.configs.base import ModelConfig, MoESpec, OffloadSpec

CONFIG = ModelConfig(
    name="tiny-moe",
    arch_type="moe",
    n_layers=6,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    block_pattern=("swa+moe",),
    sliding_window=256,
    moe=MoESpec(num_experts=8, top_k=2, aux_loss_weight=0.02),
    offload=OffloadSpec(cache_size=2, num_speculative=2, lookahead=1,
                        expert_bits=3, attn_bits=4),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="float32",
    citation="in-repo trainable proxy for arXiv:2401.04088",
)
