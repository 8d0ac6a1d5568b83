"""Shared benchmark infrastructure (the port's copy of the reference's
``benchmarks/common.py``): the trained ``tiny-moe`` and its routing trace.

The paper's Fig. 2 and Tables 1-2 measure a *trained* MoE router; random
routers have no locality.  So every benchmark first makes sure a trained
``tiny-moe`` checkpoint exists (SWA attention, top-2 of 8 experts, the
block structure of Mixtral), trained with the reference's recipe on the
byte corpus of the local Python standard library: sequences of 128,
batches of 8, a 2 MB corpus, AdamW at lr 1e-3 with 30 warmup steps, 300
steps.  The initial weights come from a CPU generator seeded with 0, so
they are the same whichever device trains.  Checkpoint and trace are
cached under ``experiments/torch/artifacts/``; results go to
``experiments/torch/bench/``.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
ART = ROOT / "experiments" / "torch" / "artifacts"
BENCH_OUT = ROOT / "experiments" / "torch" / "bench"

TRAIN_STEPS = int(os.environ.get("REPRO_BENCH_TRAIN_STEPS", "300"))
TRACE_TOKENS = int(os.environ.get("REPRO_BENCH_TRACE_TOKENS", "384"))
SEQ_LEN, BATCH, CORPUS_BYTES = 128, 8, 2_000_000


def recipe_dataset():
    """The recipe's packed byte dataset (sequences of 128, batches of 8)."""
    from repro_torch.data.pipeline import DataConfig, PackedDataset
    return PackedDataset(DataConfig(seq_len=SEQ_LEN, batch_size=BATCH,
                                    max_bytes=CORPUS_BYTES))


def checkpoint_path(steps: int) -> Path:
    return ART / f"tiny_moe_{steps}.npz"


def train_tiny_moe(steps: int, device=None, *, log_every: int = None,
                   log=print):
    """Train ``tiny-moe`` with the recipe on ``device`` (the card unless
    ``device="cpu"``).  Returns ``(params, cfg, history)``; ``log_every``
    (default ``max(20, steps // 10)``) sets how often the history records
    the metrics and the wall time."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant.hqq import tree_map
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer

    dev = resolve_device(device)
    cfg = get_config("tiny-moe")
    params = tree_map(lambda a: a.to(dev),
                      T.init_model(cfg, seed=0, device="cpu"))
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=30, total_steps=steps)
    params, _, hist = trainer.train(
        params, cfg, opt, recipe_dataset().batches(),
        trainer.TrainerConfig(steps=steps,
                              log_every=log_every or max(20, steps // 10)),
        log=log)
    return params, cfg, hist


def get_trained_tiny_moe(steps: int = None, device=None):
    """Returns ``(params, cfg)`` on ``device``, training and caching the
    checkpoint on the first call."""
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import get_config

    steps = steps or TRAIN_STEPS
    cfg = get_config("tiny-moe")
    path = checkpoint_path(steps)
    if path.exists():
        return C.restore(str(path), cfg, device), cfg
    print(f"[bench] training tiny-moe for {steps} steps (cached after)...")
    params, cfg, hist = train_tiny_moe(steps, device)
    C.save(str(path), params, cfg, meta={"steps": steps,
                                         "final_loss": hist[-1]["loss"]})
    return params, cfg


def trace_path(n_tokens: int) -> Path:
    return ART / f"trace_{TRAIN_STEPS}_{n_tokens}.npz"


def get_trace(n_tokens: int = None, device=None):
    """Expert-activation trace of the trained model over ``n_tokens`` of
    held-out text (``core/trace.collect_trace`` on ``device``), cached."""
    from repro_torch.core import trace as TR
    from repro_torch.data.pipeline import DataConfig, PackedDataset

    n_tokens = n_tokens or TRACE_TOKENS
    path = trace_path(n_tokens)
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    params, cfg = get_trained_tiny_moe(device=device)
    ds = PackedDataset(DataConfig(seq_len=n_tokens, batch_size=1,
                                  max_bytes=CORPUS_BYTES))
    batch = next(ds.eval_batches(1))
    print(f"[bench] collecting routing trace over {n_tokens} tokens...")
    tr = TR.collect_trace(params, cfg, batch["tokens"][:1], device=device)
    ART.mkdir(parents=True, exist_ok=True)
    np.savez(path, **tr)
    return tr


def emit(rows, name: str):
    """Print ``name,us_per_call,derived`` CSV rows and write them as JSON
    to ``experiments/torch/bench/<name>.json``."""
    BENCH_OUT.mkdir(parents=True, exist_ok=True)
    for r in rows:
        print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
    (BENCH_OUT / f"{name}.json").write_text(json.dumps(rows, indent=1))


def timeit(fn, *args, warmup=1, iters=3):
    """Mean microseconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` (the counterpart of the reference's ``timeit``), and the
    last output.  With a tensor argument on the card: CUDA events around
    the calls; otherwise the host clock (CPU work is synchronous)."""
    import torch
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(iters):
            out = fn(*args)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters * 1e3, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6, out
