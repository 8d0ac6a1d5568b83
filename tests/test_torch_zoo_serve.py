"""The port's attention-only config zoo served against the JAX reference,
on the CPU, at ``reduced()`` sizes (and the narrow configs of
``tests/zoo_models.py``).

* ``ContinuousEngine`` on the plain plane, on ``paged`` and
  ``dense_chunked`` (4 requests through 2 slots): every request's tokens
  and the engine step of each token exactly the reference's, the same
  slots in the same order.
* ``granite-moe-1b-a400m`` kept at 32 experts, top-8, cache 8 and 4
  speculative (widths narrowed by hand) through ``OffloadEngine`` on
  ``packed_pipelined``: tokens and every ``OffloadStats`` counter exactly
  the reference's, on the reference's quantized weights and store
  carried across by ``bridge``; the h2d bytes issued equal the counters'.
  The tail-layer config likewise: a dense tail block after an MoE period
  runs on the packed planes (the dense MLP between pool layers).
* The cost model and the roofline accept the six configs at their
  published sizes: the same bytes and modelled tokens/s as the
  reference's on one shared ``Hardware``; recurrent and encoder bytes 0.

The reference's runs are shared through module-scoped fixtures.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import parity
import zoo_models as Z
from repro.configs import get_config as jget
from repro.core import cost_model as JCM
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.serving.engine import ContinuousEngine as JContinuous
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import cost_model as PCM
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.roofline import RooflineAccountant
from repro_torch.serving.engine import ContinuousEngine as PContinuous

LENS = (5, 9, 5, 9)
MAX_NEWS = (6, 4, 5, 3)
COUNTERS = ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads",
            "expert_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return Z.Models()


def drive(eng, prompts, max_news):
    """Submit, drain; per request (tokens, emit steps), and the slots the
    requests were admitted into, in admission order."""
    emitted = {}
    reqs = [eng.submit(p, m, on_token=lambda r, t: emitted.setdefault(
        r.rid, []).append(eng.step_count)) for p, m in zip(prompts, max_news)]
    index = {r.rid: i for i, r in enumerate(reqs)}
    admitted = []
    start = eng._start_admissions

    def recording_start():
        before = {r.rid for r in eng.sched.running}
        start()
        admitted.extend((index[r.rid], r.slot) for r in eng.sched.running
                        if r.rid not in before)

    eng._start_admissions = recording_start
    try:
        eng.run(max_steps=200)
    finally:
        del eng._start_admissions
    assert all(r.state == "finished" for r in reqs)
    return [(r.generated, emitted[r.rid]) for r in reqs], admitted


@pytest.mark.parametrize("variant", ["paged", "dense_chunked"])
@pytest.mark.parametrize("arch", Z.ZOO)
def test_zoo_continuous_matches_reference(models, arch, variant):
    jc, pc, jp, pp = models(arch)
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant], max_slots=2,
              slot_len=64, eos_id=None)
    prompts = parity.make_prompts(jc, LENS)
    want = drive(JContinuous(jp, jc, **kw), prompts, MAX_NEWS)
    pce = PContinuous(pp, pc, device="cpu", **kw)
    assert drive(pce, prompts, MAX_NEWS) == want, (arch, variant)
    pce.kv.check_invariants()


@pytest.mark.parametrize("variant", ["paged", "dense"])
@pytest.mark.parametrize("name", ["phi3-hd96", "gqa3", "gqa12"])
def test_kv_layouts_at_head_dim_96_and_gqa_3_12(models, name, variant):
    """Pages and dense slot rings at phi-3's head_dim 96 and at the
    published GQA ratios 3 and 12 (``reduced()`` makes them 64 and 4):
    the same tokens and emit steps as the reference's."""
    jc, pc, jp, pp = models(name)
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant], max_slots=2,
              slot_len=64, eos_id=None)
    prompts = parity.make_prompts(jc, LENS)
    want = drive(JContinuous(jp, jc, **kw), prompts, MAX_NEWS)
    assert drive(PContinuous(pp, pc, device="cpu", **kw), prompts,
                 MAX_NEWS) == want, (name, variant)


def _store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.mark.parametrize("name", ["granite-32x8", "tail"])
def test_offload_packed_pipelined_matches_reference(models, name):
    """The reference quantizes and packs; its executable parameters and
    store cross into the port, and both generate on ``packed_pipelined``
    (batch 1, speculative staging on)."""
    jc, pc, jp, _ = models(name)
    spec = jc.offload
    if name == "granite-32x8":
        assert (jc.moe.num_experts, jc.moe.top_k, spec.cache_size,
                spec.num_speculative) == (32, 8, 8, 4)
    jeng = JEngine(jp, jc, spec, quantized=True)
    prompt = parity.make_prompts(jc, (9,))[0][None]
    jtoks, jstats = jeng.generate(prompt, 8)
    pspec = PSpec(**dataclasses.asdict(spec))
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params), pc,
                                  "cpu")
    store = bridge.store_from_numpy(_store_leaves(jeng.store), pc, pspec,
                                    "cpu")
    peng = PEngine(pp, pc, pspec, quantized=True, store=store, device="cpu")
    ptoks, pstats = peng.generate(prompt, 8)
    assert ptoks.tolist() == np.asarray(jtoks).tolist()
    got = {k: getattr(pstats, k) for k in COUNTERS}
    assert got == {k: getattr(jstats, k) for k in COUNTERS}
    assert got["demand_loads"] > 0
    assert peng._last_pool_state.h2d_bytes == pstats.bytes_h2d


HW = JCM.Hardware("shared", 20.4, 2039.0, 0.55, 1.2e-3, 0.8e-3, 80)


@pytest.mark.parametrize("arch", Z.ZOO)
def test_cost_model_and_roofline_accept_the_zoo(arch):
    jc, pc = jget(arch), pget(arch)
    bits = (jc.offload.expert_bits if jc.offload else 3)
    assert PCM.active_param_bytes(pc, bits, 4) == \
        JCM.active_param_bytes(jc, bits, 4)
    ts = (3.5, 1.25, 40.0, 2.0)
    for ctx in (0.0, 4096.0):
        assert PCM.kv_read_bytes_per_token(pc, ctx) == \
            JCM.kv_read_bytes_per_token(jc, ctx)
        assert PCM.tokens_per_second(pc, HW, PCM.TokenStats(*ts), bits,
                                     context_len=ctx) == \
            JCM.tokens_per_second(jc, HW, JCM.TokenStats(*ts), bits,
                                  context_len=ctx)
    assert PCM.recurrent_state_bytes(pc) == JCM.recurrent_state_bytes(jc) == 0
    reg = MetricsRegistry()
    RooflineAccountant(reg, pc, expert_bits=bits, attn_bits=4,
                       expert_bytes=PCM.expert_bytes(pc, bits)
                       if pc.moe else 0.0)
    snap = reg.snapshot()["roofline"]
    assert snap["rec_state_bytes_per_token"] == 0
    assert snap["enc_kv_read_bytes_per_token"] == 0
