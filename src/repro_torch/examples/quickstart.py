"""Quickstart (the port of the reference's ``examples/quickstart.py``):
train a tiny Mixtral-family MoE on real bytes, generate text, then run the
same model through the paper's offloading engine and confirm the tokens
are identical while counting the expert transfers.  On the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 120]
"""
import argparse
import sys

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.offload_engine import OffloadEngine, generate_plain
from repro_torch.data.pipeline import (DataConfig, PackedDataset,
                                       decode_bytes, encode_text)
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.training import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tiny-moe")
    print(f"== 1. train {cfg.name} "
          f"({T.count_params_analytic(cfg)/1e6:.1f}M params) on {dev} ==")
    ds = PackedDataset(DataConfig(seq_len=128, batch_size=8,
                                  max_bytes=1_500_000))
    params = T.init_model(cfg, seed=0, device=dev)
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    params, _, hist = trainer.train(
        params, cfg, opt, ds.batches(),
        trainer.TrainerConfig(steps=args.steps, log_every=20))
    assert hist[-1]["loss"] < hist[0]["loss"], "training must reduce loss"

    print("\n== 2. generate (plain decode) ==")
    prompt = encode_text("def ")[None]
    out = generate_plain(params, cfg, prompt, 48, device=dev)
    print("generated:", repr(decode_bytes(out[0])))

    print("\n== 3. same model through the offload engine ==")
    eng = OffloadEngine(params, cfg, device=dev)  # LRU k=2, 2 speculative
    out_off, stats = eng.generate(prompt, 48)
    assert (out == out_off).all(), "offloading must not change outputs!"
    print(f"identical: True | hit_ratio={stats.hit_ratio:.2f} "
          f"demand_loads={stats.demand_loads} spec_hits={stats.spec_hits}")
    naive = (stats.n_tokens * cfg.moe_layer_count * cfg.moe.num_experts
             * stats.expert_bytes)
    print(f"host->device traffic: {stats.bytes_h2d/1e6:.1f} MB "
          f"(vs naive {naive/1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
