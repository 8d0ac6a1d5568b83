"""Speculative expert loading (paper §3.2): apply layer ``l+j``'s gate to
the hidden state layer ``l``'s gate saw.  Port of the reference's
``core/speculative.py``: the online predictor of the offload engine and
the offline recall of the paper's Fig. 2 (right) over a recorded trace."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def predict_experts(router_w: torch.Tensor, hidden: torch.Tensor,
                    n_spec: int) -> torch.Tensor:
    """Top-``n_spec`` experts of the lookahead layer's router applied to the
    current layer's pre-MoE hidden state.  router_w: (D, E); hidden:
    (T, D).  Returns (T, n_spec) int32."""
    logits = hidden.to(torch.float32) @ router_w.to(torch.float32)
    return torch.topk(logits, n_spec, dim=-1).indices.to(torch.int32)


def recall_curve(hiddens: np.ndarray, routers: np.ndarray,
                 actual: np.ndarray, lookaheads: Sequence[int],
                 n_fetch_list: Sequence[int]) -> Dict:
    """Speculative-loading recall over a trace: hiddens (n_tokens,
    n_layers, D) gate inputs, routers (n_layers, D, E), actual (n_tokens,
    n_layers, top_k) routed ids.  ``out[(j, n)]`` is the fraction of layer
    ``l + j``'s active experts covered by the top-``n`` prediction made
    from layer ``l``'s hidden state."""
    n_tokens, n_layers, top_k = actual.shape
    out = {}
    for j in lookaheads:
        logits = np.einsum("tld,lde->tle", hiddens[:, : n_layers - j],
                           routers[j:])  # predict layer l+j from hidden l
        order = np.argsort(-logits, axis=-1)  # (T, L-j, E)
        tgt = actual[:, j:]  # (T, L-j, top_k)
        for n in n_fetch_list:
            pred = order[..., :n]  # (T, L-j, n)
            covered = (tgt[..., :, None] == pred[..., None, :]).any(-1)
            out[(j, n)] = float(covered.mean())
    return out
