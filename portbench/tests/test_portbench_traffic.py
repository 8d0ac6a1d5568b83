"""Traffic generation and the metric arithmetic, on the CPU."""
import itertools

import numpy as np
import pytest

from portbench import harness as H
from portbench.metrics import (itl_p95_ms, output_tokens_per_s, prefill_tokens_per_s,
                               rows_per_step, ttft_p95_ms)
from portbench.tests.conftest import small, small_mix
from portbench.traffic import generator as TR

MIXES = ("chat", "long_prompt")
BIG_SEED = 2**31 + 5


def take(mix, seed, n, vocab=32000):
    return list(itertools.islice(TR.requests(mix, seed, vocab), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests_other_seed_others(name):
    mix = TR.load_mix(name)
    a, b, c = take(mix, BIG_SEED, 40), take(mix, BIG_SEED, 40), take(mix, 7, 40)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    # a negative seed is a seed of its own, not its absolute value's
    d = take(mix, -BIG_SEED, 4)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, d))
    # every seed sends the same lengths in the same order
    assert [(len(x.prompt), x.max_new) for x in a] == [(len(y.prompt), y.max_new) for y in c]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_clip_and_every_block_alike(name):
    mix = TR.load_mix(name)
    n = mix["block"]
    for seed in (1, 2**33 + 1):
        reqs = take(mix, seed, 3 * n)
        p, o = mix["prompt_tokens"], mix["output_tokens"]
        assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
        assert all(o["min"] <= r.max_new <= o["max"] for r in reqs)
        assert all(0 <= r.prompt.min() and r.prompt.max() < 32000 for r in reqs)
        for k in range(3):
            blk = reqs[k * n: (k + 1) * n]
            assert sorted(len(r.prompt) for r in blk) == sorted(TR.quantile_lengths(p, n))
            assert sorted(r.max_new for r in blk) == sorted(TR.quantile_lengths(o, n))


@pytest.mark.parametrize("name,median", [("chat", 256), ("long_prompt", 4096)])
def test_median_of_the_quantiles_is_the_stated_median(name, median):
    mix = TR.load_mix(name)
    assert np.median(TR.quantile_lengths(mix["prompt_tokens"], 1001)) == median


def test_every_request_fits_its_slot():
    for name in MIXES:
        mix = TR.load_mix(name)
        assert (mix["prompt_tokens"]["max"] + mix["output_tokens"]["max"]
                <= mix["engine"]["slot_len"])


def test_closed_loop_keeps_its_clients_in_flight():
    cfg, mix = small("mixtral-offload"), small_mix("chat")
    drv = H.Runner(cfg, mix, 3, "cpu")
    drv.start()
    for _ in range(30):
        drv._step()
        assert sum(r.done_t is None for r in drv.records) == mix["clients"]
    assert sum(r.done_t is not None for r in drv.records) > mix["clients"]


def _run(records, t0=10.0, t1=20.0, counters=None):
    run = H.Run(cfg={}, mix={}, seconds=t1 - t0, t0=t0, t1=t1)
    run.requests = records
    run.counters = counters or {}
    return run


def test_rates_and_tails_take_every_sample_of_the_window():
    rng = np.random.default_rng(0)
    recs, firsts, gaps, n_in = [], [], [], 0
    for i in range(50):
        sub = rng.uniform(5, 19)
        toks = list(sub + np.cumsum(rng.uniform(0.01, 0.3, 20)))
        recs.append(H.ReqRecord(i, np.zeros(3), 20, sub, token_t=toks))
        if 10 <= toks[0] <= 20:
            firsts.append((toks[0] - sub) * 1e3)
        gaps += [(b - a) * 1e3 for a, b in zip(toks[:-1], toks[1:]) if 10 <= a and b <= 20]
        n_in += sum(10 <= t <= 20 for t in toks)
    run = _run(recs)
    assert ttft_p95_ms.read(run, "ttft_p95_ms") == pytest.approx(np.percentile(firsts, 95))
    assert itl_p95_ms.read(run, "itl_p95_ms") == pytest.approx(np.percentile(gaps, 95))
    assert output_tokens_per_s.read(run, "output_tokens_per_s") == pytest.approx(n_in / 10.0)


def test_a_failed_request_misses_the_tail():
    recs = [H.ReqRecord(i, np.zeros(3), 4, 10.0, token_t=[10.1]) for i in range(19)]
    recs.append(H.ReqRecord(19, np.zeros(3), 4, 10.0, done_t=11.0, failed=True))
    assert ttft_p95_ms.read(_run(recs), "ttft_p95_ms") > 1e6


def test_counter_rates_take_the_whole_window():
    run = _run([], counters={"prompt_tokens": 5000, "decode_rows": 300,
                             "engine_steps": 25})
    assert prefill_tokens_per_s.read(run, "prefill_tokens_per_s.prefill") == 500.0
    assert rows_per_step.read(run, "rows_per_step.serve") == 12.0
