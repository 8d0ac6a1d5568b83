"""Mixtral-8x7B (arXiv:2401.04088): 32 layers, d_model 4096, 32 heads
(GQA kv 8), expert d_ff 14336, vocab 32000, 8 experts top-2, sliding-window
attention (4096)."""
from repro_torch.configs.base import ModelConfig, MoESpec, OffloadSpec

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("swa+moe",),
    sliding_window=4096,
    moe=MoESpec(num_experts=8, top_k=2),
    offload=OffloadSpec(cache_size=4, num_speculative=2, lookahead=1,
                        expert_bits=3, attn_bits=4),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    citation="arXiv:2401.04088 (Mixtral of Experts)",
)
