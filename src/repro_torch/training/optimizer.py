"""Hand-rolled AdamW with a cosine schedule and global-norm clipping (the
port of the reference's ``training/optimizer.py``; not ``torch.optim``,
so that the semantics are the reference's exactly).

Parameters, gradients and moments are nested dicts and lists of tensors
in the port's layout.  The schedule and the bias corrections are
computed in float32 on the host, as the reference computes them in
float32; the update math runs in float32 on the parameters' device and
never reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.quant.hqq import tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # bf16 moments halve the optimizer's memory; the math runs in f32
    moment_dtype: str = "float32"


def schedule(cfg: OptimizerConfig, step) -> float:
    """Linear warmup, then cosine down to ``min_lr_frac`` of ``lr``, in
    float32."""
    f = np.float32
    step = f(step)
    warm = min(f(1.0), f(step + f(1)) / f(max(1, cfg.warmup_steps)))
    prog = np.clip(f(step - f(cfg.warmup_steps))
                   / f(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (
        f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * f(warm) * cos)


def init_opt_state(params, cfg: OptimizerConfig = None) -> dict:
    dt = getattr(torch, cfg.moment_dtype) if cfg else torch.float32
    zeros = lambda: tree_map(lambda a: torch.zeros_like(a, dtype=dt), params)
    return {"mu": zeros(), "nu": zeros(), "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor
    on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptimizerConfig
                  ) -> Tuple[Any, dict, dict]:
    """One AdamW step.  Returns ``(new_params, new_opt_state, {"grad_norm",
    "lr"})``; ``grad_norm`` is the pre-clipping global norm (a 0-d device
    tensor), ``lr`` this step's learning rate.  Weight decay applies to
    leaves with ``ndim >= 2`` only."""
    f = np.float32
    step = int(opt_state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = f(step + 1)
    bc1 = float(f(1) - f(cfg.b1) ** t)
    bc2 = float(f(1) - f(cfg.b2) ** t)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
        nu = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * g * g
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), mu.to(mdt), nu.to(mdt)

    out = iter([upd(*a) for a in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["mu"]),
        tree_leaves(opt_state["nu"]))])
    triples = tree_map(lambda _: next(out), params)
    new_state = {"mu": _pick(triples, 1), "nu": _pick(triples, 2),
                 "step": step + 1}
    return _pick(triples, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i):
    """Element ``i`` of every (param, mu, nu) triple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
