"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``portbench/traffic/<name>.json``) gives the engine's settings
and its closed loop, and gives each length as a clipped
lognormal (``median``, ``sigma``, ``min``, ``max``) and a ``block``
size.  Requests come in blocks: every block holds the same ``block``
prompt lengths and the same ``block`` output lengths (the distribution's
quantiles at ``(i + 0.5) / block``, clipped), paired and ordered by a
permutation that differs from block to block and is the same under
every seed.  Token ids are uniform over the vocabulary, from a generator
per request drawn from the seed.  So every seed sends the same lengths
in the same order: in a closed loop the order decides which requests
meet at admission, and with it the TTFT tail, which read 1.0 to 1.9 s
on an NVIDIA H100 over six seeds when the seed drew the order (two
runs of one seed within 5 %).
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no traffic mix {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The ``n`` quantiles of the clipped lognormal ``spec``, as ints."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclass(frozen=True)
class Req:
    index: int
    prompt: np.ndarray  # (S,) int32
    max_new: int


def _rng(seed: int, *keys: int) -> np.random.Generator:
    # numpy seeds take non-negative words: a negative seed keeps its sign
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *keys])


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Req]:
    """The endless request sequence of ``mix`` under ``seed``."""
    n = int(mix["block"])
    plens = quantile_lengths(mix["prompt_tokens"], n)
    olens = quantile_lengths(mix["output_tokens"], n)
    order = np.random.default_rng(17)
    i = 0
    while True:
        pp, po = order.permutation(n), order.permutation(n)
        for j in range(n):
            ids = _rng(seed, 29, i).integers(0, vocab, int(plens[pp[j]]))
            yield Req(i, ids.astype(np.int32), int(olens[po[j]]))
            i += 1
