"""Expert-activation traces (paper Fig. 1 / section 3; port of the
reference's ``core/trace.py``) and the routing helpers the executor and
the engine share.

:func:`collect_trace` runs a model teacher-forced over a token sequence,
token by token on the plain plane as interactive decode would, and
records for every (token, MoE layer) the top-k expert ids used, the
pre-MoE hidden state (the gate's input: what speculative loading applies
the next layer's gate to) and the full router probabilities.  The traces
feed ``lru_cache.lru_hit_curve``/``policy_comparison`` and
``speculative.recall_curve``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, parse_block
from repro_torch.models import transformer as T


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


def collect_trace(params, cfg: ModelConfig, tokens: np.ndarray, *,
                  device=None) -> Dict[str, np.ndarray]:
    """Teacher-forced trace over ``tokens`` (1, S), one token per decode
    step on ``device`` (the card unless ``device="cpu"``), read to the
    host once at the end.  Returns ``ids`` (S, L_moe, K) int32,
    ``hiddens`` (S, L_moe, D) and ``probs`` (S, L_moe, E) float32 and
    ``routers`` (L_moe, D, E)."""
    tokens = np.asarray(tokens)
    assert tokens.ndim == 2 and tokens.shape[0] == 1
    dev = resolve_device(device)
    S = tokens.shape[1]
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    state = T.init_decode_state(cfg, 1, S, dev)
    ids, hiddens, probs = [], [], []
    for t in range(S):
        _, state, infos = T.decode_step(params, cfg, state, toks[:, t:t + 1],
                                        collect_info=True)
        moe = [i for i in infos if "route" in i]
        ids.append(torch.stack([i["route"]["ids"][0] for i in moe]))
        probs.append(torch.stack([i["route"]["probs"][0] for i in moe]))
        hiddens.append(torch.stack([i["hidden_pre_moe"][0] for i in moe]))
    host = lambda xs: torch.stack(xs).cpu().numpy()
    return {
        "ids": host(ids),
        "hiddens": torch.stack(hiddens).float().cpu().numpy(),
        "probs": host(probs),
        "routers": stacked_routers(params, cfg).float().cpu().numpy(),
    }
