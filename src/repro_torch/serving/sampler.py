"""Token samplers (port of the reference's ``serving/sampler.py``):
greedy, categorical (the paper's), top-k and nucleus (top-p), with
per-request temperature as a (B,) override.

Draws come from an explicit ``torch.Generator``.  Greedy is exact; the
stochastic kinds cannot reproduce ``jax.random``'s bits, only its
distribution (the kept-token sets of the filters are the reference's).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    kind: str = "categorical"  # greedy | categorical | topk | topp
    temperature: float = 1.0
    top_k: int = 40
    top_p: float = 0.9  # nucleus mass (kind="topp")


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the
    probability-sorted vocab whose cumulative mass reaches ``top_p``
    (the most likely token always survives)."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def sample(gen: torch.Generator, logits: torch.Tensor, cfg: SamplerConfig,
           temperature=None) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.  ``temperature`` overrides
    ``cfg.temperature``: a scalar, or (B,) per-request values."""
    if cfg.kind == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    t = cfg.temperature if temperature is None else temperature
    t = torch.as_tensor(t, dtype=torch.float32, device=logits.device)
    if t.dim() == 1:
        t = t[:, None]
    logits = logits.to(torch.float32) / torch.clamp(t, min=1e-6)
    if cfg.kind == "topk":
        thresh = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                             logits)
    elif cfg.kind == "topp":
        logits = _top_p_filter(logits, cfg.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
