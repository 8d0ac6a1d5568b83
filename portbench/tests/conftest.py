"""Fixtures of the benchmark's own tests: small Mixtral- and Granite-
shaped configurations in the configuration files' keys, float32, and
small versions of the traffic mixes.  The program is found under
``src/`` of the checkout; tests that need the card are marked ``cuda``
and skip elsewhere."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.traffic import generator as TR  # noqa: E402

CONFIGS = ROOT / "portbench" / "configs"


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors under several pytest workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name: str, **kw) -> dict:
    """The configuration file ``name`` at CPU-test widths, float32."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    base = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                head_dim=16, num_hidden_layers=2, vocab_size=256,
                torch_dtype="float32")
    if name == "mixtral-offload":
        base.update(intermediate_size=128, num_local_experts=4,
                    num_experts_per_tok=2)
        off = dict(cache_size=2, num_speculative=1)
    else:
        base.update(intermediate_size=64, num_local_experts=8,
                    num_experts_per_tok=4)
        off = dict(cache_size=4, num_speculative=2)
    cfg.update(base, **kw)
    cfg["offload"] = dict(cfg["offload"], **off)
    return cfg


def small_mix(name: str) -> dict:
    """The traffic mix ``name`` at CPU-test sizes."""
    mix = TR.load_mix(name)
    eng = mix["engine"]
    # at least four clients, so that several rows decode at once, as in
    # the cells; the cell's ratio of clients to slots
    clients = 4 * max(1, eng["max_slots"] // 16)
    slots = max(1, clients * eng["max_slots"] // mix["clients"])
    long = mix["prompt_tokens"]["min"] > eng["prefill_chunk"]
    return dict(mix, clients=clients, warmup_steps=4, block=6, trace_seconds=0.3,
                engine=dict(eng, max_slots=slots, slot_len=96, prefill_chunk=16,
                            token_budget=slots + 16),
                prompt_tokens=dict(mix["prompt_tokens"], median=40 if long else 20,
                                   min=24 if long else 4, max=64 if long else 48),
                output_tokens=dict(mix["output_tokens"],
                                   median=8, min=2 if not long else 8,
                                   max=24 if not long else 8),
                sample=dict(min_tokens=30, max_requests=4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
