"""Training loop (port of the reference's ``training/trainer.py``): the
loss, a train step with gradient accumulation and activation
checkpointing, an eval step, and a simple loop with periodic eval and
checkpointing (:func:`train`).

Plain PyTorch with autograd on the parameters' device; the optimizer is
the hand-rolled AdamW of :mod:`repro_torch.training.optimizer`.  A step
reads nothing back to the host: metrics stay 0-d device tensors until
:func:`train` logs them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.quant.hqq import tree_leaves, tree_map
from repro_torch.training import optimizer as O


def loss_fn(params, cfg: ModelConfig, batch, remat: bool = False):
    """Mean next-token cross-entropy over labels >= 0, plus
    ``aux_loss_weight`` times the load-balance loss averaged over MoE
    layers.  Returns ``(loss, {"ce", "load_balance", "loss"})``."""
    logits, aux = T.forward_train(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe is not None:
        lb = aux["load_balance"] / max(1, cfg.moe_layer_count)
        loss = loss + cfg.moe.aux_loss_weight * lb
        metrics["load_balance"] = lb
    metrics["loss"] = loss
    return loss, metrics


def _grads(params, cfg, batch, remat):
    """(metrics, grads) of :func:`loss_fn` at ``params``; the gradients in
    the parameters' layout, detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch, remat)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptimizerConfig,
                    microbatches: int = 1, remat: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``microbatches`` splits the batch along its first axis
    and averages the gradients (accumulated in float32) and the metrics
    over the pieces; ``remat`` checkpoints each period's blocks
    (``transformer.forward_train``)."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            metrics, grads = _grads(params, cfg, batch, remat)
        else:
            B = batch["tokens"].shape[0]
            assert B % microbatches == 0
            n = B // microbatches
            grads, metrics = None, None
            for i in range(microbatches):
                mb = {k: v[i * n: (i + 1) * n] for k, v in batch.items()}
                m, g = _grads(params, cfg, mb, remat)
                g = tree_map(lambda a: a.to(torch.float32), g)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = _add(grads, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda a: a / microbatches, grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        params, opt_state, opt_metrics = O.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_add(x, y) for x, y in zip(a, b)]
    return a + b


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, cfg, batch)[1]

    return eval_step


@dataclass
class TrainerConfig:
    steps: int = 200
    log_every: int = 10
    eval_every: int = 100
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def train(params, cfg: ModelConfig, opt_cfg: O.OptimizerConfig,
          batches: Iterable[Dict[str, np.ndarray]], tcfg: TrainerConfig,
          eval_batches: Optional[Callable[[], Iterable]] = None,
          log: Callable[[str], None] = print):
    """Train on the parameters' device for ``tcfg.steps`` steps.  Every
    ``log_every`` steps (and the last) the metrics are read to the host
    and appended to the history with the step and the wall time since
    the start.  Returns ``(params, opt_state, history)``."""
    dev = _device(params)
    step_fn = make_train_step(cfg, opt_cfg)
    opt_state = O.init_opt_state(params)
    history = []
    t0 = time.perf_counter()
    it = iter(batches)
    for step in range(tcfg.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             to_device(next(it), dev))
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} "
                f"({m['wall_s']:.0f}s)")
        if (eval_batches is not None and tcfg.eval_every
                and step and step % tcfg.eval_every == 0):
            log(f"  eval ce {eval_ce(params, cfg, eval_batches()):.4f}")
        if (tcfg.checkpoint_path and tcfg.checkpoint_every
                and step and step % tcfg.checkpoint_every == 0):
            from repro_torch.checkpoint.checkpointer import save
            save(tcfg.checkpoint_path, params, cfg,
                 meta={"step": step, "config": cfg.name})
    return params, opt_state, history


def eval_ce(params, cfg: ModelConfig, batches) -> float:
    """Mean of the per-batch cross-entropies, on the parameters' device."""
    dev = _device(params)
    eval_fn = make_eval_step(cfg)
    vals = [float(eval_fn(params, to_device(b, dev))["ce"]) for b in batches]
    return float(np.mean(vals))
