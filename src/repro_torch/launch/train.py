"""Training launcher of the port (the reference's ``launch/train.py``), on
the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-moe --steps 200

The same flags as the reference's, plus ``--device``.  On the CPU a
config with ``d_model > 1024`` or a vocabulary over 100k trains as its
``reduced()`` variant, as the reference's launcher does on its host; on
the card only ``--reduced`` reduces, and a model whose weights,
gradients and AdamW moments exceed the card's free memory is refused
with the bytes it needs (``cost_model.check_fits``).  ``--microbatches``
and ``--remat`` reach the train step (``trainer.TrainerConfig``).
``--checkpoint`` writes the reference's checkpoint format, which
``launch.serve --checkpoint`` (of either package) reads.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import DataConfig, PackedDataset
from repro_torch.core import cost_model as CM
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.training import trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-moe", choices=list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--corpus-bytes", type=int, default=4_000_000)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(f"{cfg.name} is encoder-decoder: its batches need "
                         f"audio_embeds, which the text pipeline does not "
                         f"make")
    if args.reduced or (dev.type == "cpu" and (cfg.vocab_size > 100_000
                                               or cfg.d_model > 1024)):
        cfg = cfg.reduced()
        print(f"[train] using reduced variant: {cfg.name}")
    n = T.count_params_analytic(cfg)
    CM.check_fits(CM.resident_bytes(cfg, training=True),
                  f"training {cfg.name} ({n / 1e9:.2f}B parameters)", dev)
    ds = PackedDataset(DataConfig(seq_len=args.seq_len,
                                  batch_size=args.batch_size,
                                  max_bytes=args.corpus_bytes,
                                  seed=args.seed))
    params = T.init_model(cfg, seed=args.seed, device=dev)
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps x "
          f"{args.batch_size}x{args.seq_len} tokens on {dev}")
    opt = O.OptimizerConfig(lr=args.lr,
                            warmup_steps=min(100, args.steps // 10 + 1),
                            total_steps=args.steps)
    tcfg = trainer.TrainerConfig(
        steps=args.steps, log_every=10, eval_every=max(50, args.steps // 4),
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.steps // 2 if args.checkpoint else 0,
        microbatches=args.microbatches, remat=args.remat)
    params, _, hist = trainer.train(
        params, cfg, opt, ds.batches(), tcfg,
        eval_batches=lambda: ds.eval_batches(4))
    if args.checkpoint:
        from repro_torch.checkpoint.checkpointer import save
        save(args.checkpoint, params, cfg,
             meta={"arch": cfg.name, "steps": args.steps})
        print(f"[train] saved {args.checkpoint}")
    print(f"[train] final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
