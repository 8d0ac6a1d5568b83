"""Batched serving (the port of the reference's ``examples/serve_batch.py``):
several requests through the static serving engine, sampling in
proportion to the predicted probabilities (the paper's evaluation
protocol), on the trained ``tiny-moe`` (trained and cached on first use).
On the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.serve_batch
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.benchmarks.common import get_trained_tiny_moe
from repro_torch.data.pipeline import decode_bytes, encode_text
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampler import SamplerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, cfg = get_trained_tiny_moe(device=dev)
    eng = ServeEngine(params, cfg, SamplerConfig(kind="categorical",
                                                 temperature=0.8), device=dev)
    prompts = ["def ", "import ", "class F", "return ", "for i in "]
    reqs = [Request(encode_text(p), max_new_tokens=40) for p in prompts]
    for p, r in zip(prompts, eng.serve_batch(reqs, seed=7)):
        print(f"{p!r:14s} -> {decode_bytes(np.array(r.completed))!r}")


if __name__ == "__main__":
    main()
