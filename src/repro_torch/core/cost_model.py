"""The byte arithmetic of offloading (port of the part of the reference's
``core/cost_model.py`` that accounting mode needs): effective bits per
parameter of each HQQ scheme and the bytes of one expert.

The reference's hardware rows and throughput model (``Hardware``,
``tokens_per_second``, ``replay_policies``) are not ported yet (ROADMAP
queue 1, item 2).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# bits/param including group scale/zero + meta-quant overhead (what
# quant/hqq.bits_per_param gives on the paper's group-size schemes)
EFFECTIVE_BITS = {16: 16.0, 8: 8.5, 4: 4.5, 3: 3.5, 2: 3.25}


def expert_param_count(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff  # swiglu experts (gate/up/down)


def expert_bytes(cfg: ModelConfig, bits: int) -> float:
    return expert_param_count(cfg) * EFFECTIVE_BITS[bits] / 8.0
