"""End-to-end run (the port of the reference's
``examples/train_moe_100m.py``): train a ~100M-parameter MoE language
model for a few hundred steps on the byte corpus, with eval,
checkpointing and generation at the end.  On the card unless ``--device
cpu``::

    PYTHONPATH=src python -m repro_torch.examples.train_moe_100m [--steps 300]

The config is a granite-style MoE (8 experts, top-2) of ~100M total
parameters; its checkpoint is in the reference's format.
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import save
from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.data.pipeline import (DataConfig, PackedDataset,
                                       decode_bytes, encode_text)
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training import optimizer as O
from repro_torch.training import trainer

CFG_100M = ModelConfig(
    name="moe-100m",
    arch_type="moe",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=49152,
    block_pattern=("swa+moe",),
    sliding_window=256,
    moe=MoESpec(num_experts=8, top_k=2, aux_loss_weight=0.02),
    tie_embeddings=True,
    dtype="float32",
    citation="in-repo 100M-scale example (granite/mixtral family)",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--out", default="experiments/torch/artifacts/moe_100m.npz")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CFG_100M
    n = T.count_params_analytic(cfg)
    active = n - cfg.moe_layer_count * (cfg.moe.num_experts - cfg.moe.top_k) \
        * 3 * cfg.d_model * cfg.d_ff
    print(f"[100m] {cfg.name}: {n/1e6:.1f}M total / {active/1e6:.1f}M active "
          f"on {dev}")
    ds = PackedDataset(DataConfig(seq_len=args.seq_len,
                                  batch_size=args.batch_size,
                                  max_bytes=8_000_000))
    params = T.init_model(cfg, seed=0, device=dev)
    opt = O.OptimizerConfig(lr=6e-4, warmup_steps=40, total_steps=args.steps)
    t0 = time.time()
    params, _, hist = trainer.train(
        params, cfg, opt, ds.batches(),
        trainer.TrainerConfig(steps=args.steps, log_every=10, eval_every=100),
        eval_batches=lambda: ds.eval_batches(4))
    print(f"[100m] {args.steps} steps in {time.time()-t0:.0f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    save(args.out, params, cfg, meta={"arch": cfg.name, "steps": args.steps,
                                      "final_loss": hist[-1]["loss"]})

    eng = ServeEngine(params, cfg, SamplerConfig(kind="greedy"), device=dev)
    reqs = [Request(encode_text(p), 48) for p in ("def ", "class ", "import ")]
    for r in eng.serve_batch(reqs):
        print("sample:", repr(decode_bytes(np.array(r.completed))))


if __name__ == "__main__":
    main()
