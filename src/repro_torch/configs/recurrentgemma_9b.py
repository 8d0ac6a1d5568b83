"""RecurrentGemma-9B — Griffin hybrid: RG-LRU recurrent blocks + local
(sliding-window) attention in a 2:1 pattern.  [arXiv:2402.19427]

38L, d_model=4096, 16 heads (MQA kv=1), d_ff=12288 (GeGLU), vocab=256000,
local attention window 2048, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,  # 12 full (rglru, rglru, swa) periods + 2 tail rglru layers
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru+mlp", "rglru+mlp", "swa+mlp"),
    sliding_window=2048,
    mlp_act="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    logit_softcap=30.0,
    citation="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)
