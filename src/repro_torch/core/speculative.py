"""Speculative expert loading (paper §3.2): apply layer ``l+j``'s gate to
the hidden state layer ``l``'s gate saw.  Port of the reference's
``core/speculative.py``."""
from __future__ import annotations

import torch


def predict_experts(router_w: torch.Tensor, hidden: torch.Tensor,
                    n_spec: int) -> torch.Tensor:
    """Top-``n_spec`` experts of the lookahead layer's router applied to the
    current layer's pre-MoE hidden state.  router_w: (D, E); hidden:
    (T, D).  Returns (T, n_spec) int32."""
    logits = hidden.to(torch.float32) @ router_w.to(torch.float32)
    return torch.topk(logits, n_spec, dim=-1).indices.to(torch.int32)
