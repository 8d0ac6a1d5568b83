"""xLSTM-1.3B — sLSTM + mLSTM recurrent blocks.  [arXiv:2405.04517]

48L, d_model=2048, 4 heads (head_dim 512), d_ff=0 (xLSTM blocks carry their
own projections), vocab=50304.  Pattern: 5 mLSTM blocks then 1 sLSTM block
per period (8 periods), approximating the paper's sparse sLSTM placement.
Attention-free: sub-quadratic by construction (long_500k native).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm+none",) * 5 + ("slstm+none",),
    norm="rmsnorm",
    mlstm_chunk=256,
    citation="arXiv:2405.04517 (xLSTM)",
)
