"""Routing helpers shared by the executor and the engine (port of the
reference's ``core/trace.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, parse_block


def moe_positions(cfg: ModelConfig):
    """Pattern positions whose block has an MoE FFN."""
    return [i for i, k in enumerate(cfg.block_pattern)
            if parse_block(k)[1] == "moe"]


def stacked_routers(params, cfg: ModelConfig) -> torch.Tensor:
    """(n_moe_layers, D, E) router weights, in layer order."""
    pos = set(moe_positions(cfg))
    return torch.stack([lp["moe"]["router"]
                        for l, lp in enumerate(params["layers"])
                        if l % cfg.pattern_period in pos])
