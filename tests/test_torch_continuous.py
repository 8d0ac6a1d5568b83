"""The port's continuous batching over the offloaded expert pool on paged
KV against the JAX reference's, as a whole, on ``tiny-moe`` cut to 2
layers, on the CPU.

Both sides run ``ContinuousEngine(offload=..., kv_page=16)`` with two
slots over the same prompts and ``max_news``, on the paged variants of
``tests/parity.py``: ``paged``, ``paged_exact`` (full-width table) and
``paged_chunked`` (budgeted 4-token chunks).  The reference's packed
engine quantizes; its executable weights and packed store cross into the
port through ``repro_torch.bridge``.  Required: every request's tokens
equal, each token emitted at the same engine step, the ``offload_*``
counters equal, and the h2d bytes the port issued equal to the
counters'.  Two rows of top-2 over a 2-slot pool (T*K = 4 > cache_size)
make accesses lose their slot within a batch: the overflow tier serves
them, and the test asserts that this happened.
"""
import dataclasses

import jax
import numpy as np
import pytest

import parity
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.models import transformer as JT
from repro.serving.engine import ContinuousEngine as JContinuous
from repro.serving.scheduler import ExpertOverlapPolicy as JOverlap
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.scheduler import ExpertOverlapPolicy as POverlap

LENS = (5, 9, 5, 9)
MAX_NEWS = (6, 4, 5, 3)
OFFLOAD_KEYS = ("offload_hits", "offload_spec_hits", "offload_demand_loads",
                "offload_spec_loads", "offload_bytes_h2d",
                "offload_bytes_per_token")


def store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.fixture(scope="module")
def engines():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    jspec = JSpec(cache_size=2, num_speculative=2, lookahead=1,
                  expert_bits=3, attn_bits=4)
    jeng = JEngine(JT.init_model(jax.random.key(0), jcfg), jcfg, jspec,
                   quantized=True)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    pspec = PSpec(**dataclasses.asdict(jspec))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                      pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    peng = PEngine(params, pcfg, pspec, quantized=True, store=store,
                   device="cpu")
    return jcfg, jeng, pcfg, peng


def drive(eng, prompts, max_news):
    """Submit, drain; returns per request (tokens, emit steps) and, per
    decode call, (step, {request index: slot}, route ids)."""
    emitted = {}
    calls = []
    order = {}
    dec = eng._exec.decode

    def recording_decode(*a, **kw):
        out = dec(*a, **kw)
        rows = {order[r.rid]: r.slot for r in eng.sched.running
                if r.rid in order}
        calls.append((eng.step_count, rows,
                      [np.asarray(i) for i in out[3]]))
        return out

    eng._exec.decode = recording_decode
    try:
        reqs = []
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            r = eng.submit(p, m, on_token=lambda r, t: emitted.setdefault(
                r.rid, []).append(eng.step_count))
            order[r.rid] = i
            reqs.append(r)
        eng.run(max_steps=200)
    finally:
        del eng._exec.decode
    assert all(r.state == "finished" for r in reqs)
    return [(r.generated, emitted[r.rid]) for r in reqs], calls


def first_divergence(jcalls, pcalls):
    """The first request, step and layer whose routed ids differ."""
    for (js, jrows, jids), (ps, prows, pids) in zip(jcalls, pcalls):
        for i, slot in sorted(jrows.items()):
            for l, (a, b) in enumerate(zip(jids, pids)):
                if prows.get(i) != slot or not (a[slot] == b[slot]).all():
                    return (f"request {i}, step {js}, layer {l}: port ids "
                            f"{b[prows.get(i, slot)]} vs {a[slot]}")
    return "routing equal; tokens differ after the last decode"


@pytest.mark.parametrize("variant", ["paged", "paged_exact",
                                     "paged_chunked"])
def test_continuous_matches_reference(engines, variant):
    jcfg, jeng, pcfg, peng = engines
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant], max_slots=2,
              slot_len=64, eos_id=None)
    prompts = parity.make_prompts(jcfg, LENS)
    jce = JContinuous(None, jcfg, offload=jeng, **kw)
    pce = PContinuous(None, pcfg, offload=peng, **kw)
    jres, jcalls = drive(jce, prompts, MAX_NEWS)
    pres, pcalls = drive(pce, prompts, MAX_NEWS)
    if [t for t, _ in pres] != [t for t, _ in jres]:
        pytest.fail(f"{variant}: tokens differ, "
                    f"{first_divergence(jcalls, pcalls)}")
    assert [s for _, s in pres] == [s for _, s in jres], "emit steps differ"
    js, ps = jce.stats(), pce.stats()
    assert {k: ps[k] for k in OFFLOAD_KEYS} == {k: js[k] for k in OFFLOAD_KEYS}
    st = pce._pstate
    assert st.h2d_bytes == (st.counts[2] + st.counts[3]) * peng.expert_bytes
    assert st.overflow_accesses > 0  # T*K > cache_size really overflowed
    assert EP.pool_coherent(peng.store, st)
    pce.kv.check_invariants()
    assert pce.kv.pool.n_free == pce.kv.pool.n_pages


def test_overlap_policy_serves_like_reference(engines):
    """Admission by expert overlap: the same requests admitted in the
    same order, so the same tokens at the same steps."""
    jcfg, jeng, pcfg, peng = engines
    prompts = parity.make_prompts(jcfg, (5, 9, 9, 5, 9), seed=4)
    news = (3, 5, 2, 4, 3)
    kw = dict(kv_page=16, max_slots=2, slot_len=64, eos_id=None)
    jce = JContinuous(None, jcfg, offload=jeng,
                      policy=JOverlap(jeng.params, jcfg), **kw)
    pce = PContinuous(None, pcfg, offload=peng,
                      policy=POverlap(peng.params, pcfg), **kw)
    jres, jcalls = drive(jce, prompts, news)
    pres, pcalls = drive(pce, prompts, news)
    assert pres == jres, first_divergence(jcalls, pcalls)


@pytest.mark.parametrize("kw,exc", [
    (dict(prefix_cache_pages=4), NotImplementedError),
    (dict(preemption=True), NotImplementedError),
    (dict(kv_host_pages=2), NotImplementedError),
    # draft-and-verify is ported: k >= 1 without a draft model is refused
    (dict(num_draft_tokens=2), ValueError),
    (dict(faults=object()), NotImplementedError),
    (dict(telemetry=object()), NotImplementedError)],
    ids=["prefix", "preemption", "host-swap", "drafts", "faults",
         "telemetry"])
def test_out_of_scope_arguments_are_refused(engines, kw, exc):
    _, _, pcfg, peng = engines
    with pytest.raises(exc):
        PContinuous(None, pcfg, offload=peng, **{"kv_page": 16, **kw})


def test_cancel_and_sampling_release_every_page(engines):
    """A waiting and a running request cancelled between steps end
    ``cancelled`` and give their slot and pages back; a categorical
    sampler with per-request temperatures serves the rest to the end."""
    jcfg, _, pcfg, peng = engines
    from repro_torch.serving.sampler import SamplerConfig
    eng = PContinuous(None, pcfg, offload=peng, kv_page=16, max_slots=2,
                      slot_len=64, eos_id=None,
                      sampler=SamplerConfig(kind="topp", top_p=0.8))
    prompts = parity.make_prompts(jcfg, (5, 9, 5, 9))
    reqs = [eng.submit(p, 4, temperature=t)
            for p, t in zip(prompts, (0.7, None, 1.3, None))]
    eng.step()
    assert eng.cancel(reqs[1].rid) and eng.cancel(reqs[3].rid)
    assert not eng.cancel(reqs[3].rid)
    eng.run(max_steps=50)
    assert [r.status for r in reqs] == ["completed", "cancelled",
                                        "completed", "cancelled"]
    assert all(len(reqs[i].generated) == 4 for i in (0, 2))
    assert all(0 <= t < pcfg.vocab_size for i in (0, 2)
               for t in reqs[i].generated)
    eng.kv.check_invariants()
    assert eng.kv.pool.n_free == eng.kv.pool.n_pages and eng.kv.n_free == 2
