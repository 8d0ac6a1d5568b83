"""The fault plane and the request lifecycle in the port against the JAX
reference, on ``tiny-moe`` cut to 2 layers, on the CPU, at the sizes of
the reference's ``tests/test_faults.py``.  Weights are the reference's
seeded ones crossed over by ``repro_torch.bridge``; prompts are made from
a seed with numpy.

* ``FaultInjector``: the port's fires exactly as the reference's, draw
  for draw, for the same schedule and seed (rates, ``at``, ``max_fires``,
  ``start``, several sites consulted in between); ``parse``, ``stats``
  and the validation errors equal.
* Engine parity, one case per engine test of the reference's file, on the
  same inputs and the same actions between steps (cancels): every
  request's tokens, the engine step of each token, the statuses and the
  ``stats()`` keys (``faults_*``, ``kv_*``, ``prefix_*``, ``kv_host_*``,
  ``offload_*``, the engine's) exactly equal to the reference's.  The
  cases: a cancel on every KV overlay of ``tests/parity.py``, while
  queued, on pages (the pool back to empty), while swapped out; the
  bounded queue; step and wall-clock deadlines; NaN quarantine on the
  plain and the packed plane; a transient expert-fetch fault (retried) and
  a permanent one (every MoE layer degraded to store-direct: the port's
  degraded run held to the reference's degraded run, offload counters
  included); swap-out, swap-in and page-pool faults under preemption; a
  clean run.  Survivors' tokens also equal the fault-free reference
  streams, and victims hold a strict prefix of theirs.  Every port engine
  runs ``check_invariants=True``.
* A degraded decode (every fetch failing) against the pool path: the
  same tokens, logits within ``DEGRADED_ATOL`` (not bitwise).
* ``check_invariants`` fails once the page ledger is corrupted.
"""
import dataclasses
import heapq

import jax
import numpy as np
import pytest
import torch

import parity
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.core.offload_engine import generate_plain as jgenerate
from repro.core.offload_engine import quantize_for_offload as jquantize
from repro.models import transformer as JT
from repro.serving import faults as JF
from repro.serving.engine import ContinuousEngine as JContinuous
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.serving import faults as PF
from repro_torch.serving.engine import ContinuousEngine as PContinuous

LENS, MAX_NEWS = (6, 12, 5), (6, 8, 6)
PREEMPT_LENS, PREEMPT_MAX_NEW = (12, 14, 10, 12), 10
DEGRADED_ATOL = 1e-5  # f32 logits of the same products summed in another order


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ======================================================================
# the injector
SCHEDULES = [
    ("expert_fetch=0.5", 7), ("expert_fetch=0.5", 8),
    ("expert_fetch=0.05,nan_logits@3", 0),
    ("swap_out@1@3,page_pool=1.0", 0),
    ("swap_in=0.3,slow_step@5:25,nan_logits@0@2", 11)]


@pytest.mark.parametrize("text,seed", SCHEDULES)
def test_injector_fires_like_reference(text, seed):
    """Draw for draw, every site consulted in a seeded interleaving."""
    ref, port = JF.FaultInjector.parse(text, seed), PF.FaultInjector.parse(
        text, seed)
    order = np.random.default_rng(seed).integers(0, len(PF.SITES), 400)
    got = [port.fires(PF.SITES[i]) for i in order]
    want = [ref.fires(JF.SITES[i]) for i in order]
    assert got == want
    assert port.stats() == ref.stats() and port.opportunities == \
        ref.opportunities
    assert port.stall_ms() == ref.stall_ms()


def test_injector_schedule_algebra_like_reference():
    for mod in (JF, PF):
        mod._inj = mod.FaultInjector(
            [mod.FaultSpec(site="swap_out", at=(1, 3), max_fires=2),
             mod.FaultSpec(site="page_pool", rate=1.0, start=2,
                           max_fires=3)], seed=0)
    for site in ("swap_out", "page_pool", "nan_logits"):
        assert [PF._inj.fires(site) for _ in range(6)] == \
            [JF._inj.fires(site) for _ in range(6)]
    assert PF._inj.stats() == JF._inj.stats()
    assert PF._inj.stats()["fired_swap_out"] == 2
    del JF._inj, PF._inj


def test_injector_parse_and_validation_like_reference():
    text = "expert_fetch=0.05, nan_logits@2, swap_out@0@4, slow_step@5:25"
    ref, port = JF.FaultInjector.parse(text, 9), PF.FaultInjector.parse(
        text, 9)
    assert port.seed == ref.seed == 9
    assert {k: dataclasses.asdict(v) for k, v in port.schedule.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.schedule.items()}
    assert PF.SITES == JF.SITES
    assert PF.FaultInjector.parse("").schedule == {}
    for bad, exc in ((lambda m: m.FaultSpec(site="warp_core"), ValueError),
                     (lambda m: m.FaultSpec(site="swap_out", rate=1.5),
                      ValueError),
                     (lambda m: m.FaultInjector(
                         [m.FaultSpec(site="swap_out"),
                          m.FaultSpec(site="swap_out", rate=0.1)]),
                      ValueError),
                     (lambda m: m.FaultInjector().fires("expert_fetchh"),
                      KeyError),
                     (lambda m: m.FaultInjector.parse("no_such_site=0.5"),
                      ValueError)):
        for mod in (JF, PF):
            with pytest.raises(exc):
                bad(mod)


# ======================================================================
# engine parity
def store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    # the reference test's packed engine, and its dequantized weights
    # for the fault-free oracle of the packed plane
    jspec = JSpec(cache_size=4, num_speculative=2, expert_bits=3,
                  attn_bits=4)
    qdeq, _ = jquantize(params, jcfg, jspec)
    jeng = JEngine(params, jcfg, jspec, quantized=True)
    pspec = PSpec(**dataclasses.asdict(jspec))
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    peng = PEngine(pp, pcfg, pspec, quantized=True, store=store, device="cpu")
    return {"jcfg": jcfg, "pcfg": pcfg, "params": params, "pparams": pparams,
            "qdeq": qdeq, "jeng": jeng, "peng": peng}


def injector(mod, spec):
    """A fresh injector of ``mod`` from a parse string or a FaultSpec kwargs
    dict (each run replays its schedule from the start)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        return mod.FaultInjector.parse(spec, seed=0)
    return mod.FaultInjector([mod.FaultSpec(**spec)], seed=0)


def preempt_kw():
    return dict(max_slots=3, slot_len=64, kv_page=4, kv_pages_total=13,
                preemption=True, kv_host_pages=12)


# name -> (plane, lens, max_news, engine kwargs, fault spec, submit kwargs,
#          action); ``action(eng, reqs, step)`` runs after each step and
#          returns the rids it ended
def _cancel_at(step, index):
    def act(eng, reqs, n):
        if n == step:
            assert eng.cancel(reqs[index].rid)
            assert not eng.cancel(reqs[index].rid)
            return {reqs[index].rid}
        return set()
    return act


def _cancel_queued(eng, reqs, n):
    if n == 0:  # before any step
        assert eng.cancel(reqs[2].rid)
        return {reqs[2].rid}
    return set()


def _cancel_swapped(eng, reqs, n):
    if n >= 0 and eng._swapped and not getattr(eng, "_done_cancel", False):
        eng._done_cancel = True
        rid = eng._swapped[0].req.rid
        assert eng.cancel(rid)
        return {rid}
    return set()


CASES = {f"cancel_{v}": ("plain", LENS, MAX_NEWS,
                         dict(parity.CONTINUOUS_KV_VARIANTS[v], max_slots=2),
                         None, {}, _cancel_at(2, 1))
         for v in sorted(parity.CONTINUOUS_KV_VARIANTS)}
CASES.update({
    "cancel_queued": ("plain", LENS, MAX_NEWS, dict(max_slots=2), None, {},
                      _cancel_queued),
    "cancel_pages_restored": ("plain", LENS, MAX_NEWS,
                              dict(max_slots=2, kv_page=4), None, {},
                              _cancel_at(2, 0)),
    "queue_cap": ("plain", (5, 5, 5, 5), (4,) * 4,
                  dict(max_slots=1, queue_cap=1), None, {}, None),
    "step_deadline": ("plain", (6, 5), (20, 20), dict(max_slots=2), None,
                      dict(deadline_steps=3), None),
    "wallclock_deadline": ("plain", (6, 5), (50, 50),
                           dict(max_slots=2, deadline_ms=5.0),
                           dict(site="slow_step", rate=1.0, stall_ms=30.0),
                           {}, None),
    "nan_plain": ("plain", LENS, MAX_NEWS, dict(max_slots=3), "nan_logits@1",
                  {}, None),
    "nan_packed": ("packed", LENS, MAX_NEWS, dict(max_slots=3, slot_len=48),
                   "nan_logits@1", {}, None),
    "fetch_transient": ("packed", LENS, MAX_NEWS,
                        dict(max_slots=3, slot_len=48), "expert_fetch@0", {},
                        None),
    "fetch_degraded": ("packed", LENS, MAX_NEWS,
                       dict(max_slots=3, slot_len=48),
                       dict(site="expert_fetch", rate=1.0), {}, None),
    "swap_out_fault": ("plain", PREEMPT_LENS, (PREEMPT_MAX_NEW,) * 4,
                       preempt_kw(), dict(site="swap_out", rate=1.0), {},
                       None),
    "swap_in_fault": ("plain", PREEMPT_LENS, (PREEMPT_MAX_NEW,) * 4,
                      preempt_kw(), dict(site="swap_in", at=(0,)), {}, None),
    "page_pool_fault": ("plain", PREEMPT_LENS, (PREEMPT_MAX_NEW,) * 4,
                        preempt_kw(), dict(site="page_pool", rate=0.5,
                                           max_fires=6), {}, None),
    "cancel_swapped": ("plain", PREEMPT_LENS, (PREEMPT_MAX_NEW,) * 4,
                       preempt_kw(), None, {}, _cancel_swapped),
    "clean": ("plain", LENS, MAX_NEWS, dict(max_slots=2), None, {}, None),
})


def run_case(name, side, m):
    """One case on the reference (``side`` "ref") or the port: the record
    the two are held to, and the victims' rids."""
    plane, lens, news, kw, spec, submit_kw, action = CASES[name]
    ref = side == "ref"
    cfg = m["jcfg"] if ref else m["pcfg"]
    kw = {"slot_len": 64, **kw, "eos_id": None,
          "faults": injector(JF if ref else PF, spec)}
    if ref:
        cls = JContinuous
    else:
        cls = PContinuous
        kw.update(device="cpu", check_invariants=True)
    if plane == "packed":
        eng = cls(None, cfg, offload=m["jeng"] if ref else m["peng"], **kw)
    else:
        eng = cls(m["params"] if ref else m["pparams"], cfg, **kw)
    prompts = parity.make_prompts(m["jcfg"], lens,
                                  seed=2 if name == "queue_cap" else
                                  4 if "deadline" in name else 1)
    steps = {}
    reqs = [eng.submit(p, n, on_token=lambda r, t: steps.setdefault(
        r.rid, []).append(eng.step_count), **submit_kw)
        for p, n in zip(prompts, news)]
    victims = set()
    n = 0
    if action is not None:
        victims |= action(eng, reqs, n)
    while eng.sched.has_waiting or eng.sched.n_running or eng._swapped:
        eng.step()
        n += 1
        if action is not None:
            victims |= action(eng, reqs, n)
        assert n < 400, "engine hung"
    if not ref:
        eng.check_invariants()
    s = eng.stats()
    rec = {"tokens": [r.generated for r in reqs],
           "steps": [steps.get(r.rid, []) for r in reqs],
           "status": [r.status for r in reqs],
           "stats": {k: v for k, v in s.items() if not k.startswith("jit_")}}
    victims = {i for i, r in enumerate(reqs) if r.rid in victims}
    return rec, victims, eng, prompts


@pytest.fixture(scope="module")
def reference_runs(model):
    return {name: run_case(name, "ref", model)[:2] for name in CASES}


def oracle(m, plane, prompts, news):
    """The fault-free streams: ``generate_plain`` of the reference over its
    weights (the packed plane's: the dequantized ones)."""
    w = m["params"] if plane == "plain" else m["qdeq"]
    return [jgenerate(w, m["jcfg"], p[None], n)[0].tolist()
            for p, n in zip(prompts, news)]


def first_difference(got, want):
    for key in want:
        if got[key] != want[key]:
            if isinstance(want[key], dict):
                bad = sorted(k for k in set(want[key]) | set(got[key])
                             if got[key].get(k) != want[key].get(k))
                return f"{key}: " + ", ".join(
                    f"{k} port {got[key].get(k)!r} vs {want[key].get(k)!r}"
                    for k in bad[:6])
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                if g != w:
                    return f"{key}[request {i}]: port {g} vs {w}"
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_reference(name, model, reference_runs):
    got, victims, eng, prompts = run_case(name, "port", model)
    want, want_victims = reference_runs[name]
    diff = first_difference(got, want)
    assert diff is None, f"{name}: {diff}"
    assert victims == want_victims
    plane, _, news, *_ = CASES[name]
    s = got["stats"]
    # survivors bitwise the fault-free streams; victims a strict prefix
    if name not in ("queue_cap", "step_deadline", "wallclock_deadline"):
        streams = oracle(model, plane, prompts, news)
        failed = {i for i, st in enumerate(got["status"]) if st == "failed"}
        for i, (toks, w) in enumerate(zip(got["tokens"], streams)):
            if i in victims | failed:
                assert len(toks) < len(w) and toks == w[:len(toks)], i
            else:
                assert got["status"][i] == "completed" and toks == w, i
    # what each case is for happened
    if name.startswith("cancel"):
        assert s["faults_cancelled"] == 1 and len(victims) == 1
    if name == "cancel_pages_restored":
        pool = eng.kv.pool
        assert pool.n_free == pool.n_pages and pool.refs == {}
        assert not pool.reserved
    if name == "queue_cap":
        assert s["queue_rejected"] == s["faults_rejected"] == 3
        assert got["status"] == ["completed"] + ["rejected"] * 3
    if name.endswith("deadline"):
        assert set(got["status"]) == {"deadline_exceeded"}
        assert s["faults_deadline_exceeded"] == 2
    if name.startswith("nan"):
        assert s["faults_nan_quarantined"] == s["faults_failed"] == 1
    if name == "fetch_transient":
        assert s["faults_fetch_retries"] >= 1 and \
            s["faults_fetch_degraded"] == 0
    if name == "fetch_degraded":
        assert s["faults_fetch_degraded"] > 0
        assert s["faults_fetch_retries"] >= 2 * s["faults_fetch_degraded"]
        # no layer went through the pool: no load, no hit
        assert s["offload_hits"] == s["offload_demand_loads"] == 0
    if name.endswith("_fault"):
        site = name[:-len("_fault")]
        assert s[f"faults_fired_{site}"] >= 1
        assert eng.kv.host.in_use == 0
    if name == "swap_out_fault":
        assert s["kv_host_recomputes"] >= 1
    if name == "clean":
        assert s["faults_enabled"] == s["faults_injected"] == 0
        assert s["faults_completed"] == len(LENS)


def test_invariant_checker_catches_corruption(model):
    """Positive control: the audit passes on a live engine and fails once
    a page leaks from the free heap."""
    prompts = parity.make_prompts(model["jcfg"], LENS)
    eng = PContinuous(model["pparams"], model["pcfg"], max_slots=2,
                      slot_len=64, eos_id=None, kv_page=4,
                      check_invariants=True, device="cpu")
    for p, n in zip(prompts, MAX_NEWS):
        eng.submit(p, n)
    eng.step(), eng.step()
    eng.check_invariants()
    heapq.heappop(eng.kv.pool._free)
    with pytest.raises(AssertionError):
        eng.check_invariants()


def test_degraded_decode_matches_pool_path(model):
    """Every fetch failing: each decode MoE layer runs store-direct through
    the prefill tier (the batched binding's plain version) instead of the
    pool (the slot binding's).  The same function of the same packed
    weights: logits within ``DEGRADED_ATOL`` of the pool path's at every
    step and the same tokens; not bitwise (the two sum in another order),
    so the reference's "bitwise the pool path" is held here by tokens."""
    peng, cfg = model["peng"], model["pcfg"]
    prompts = parity.make_prompts(model["jcfg"], LENS)
    logits = {}
    for name, spec in (("pool", None), ("degraded", "expert_fetch=1.0")):
        eng = PContinuous(None, cfg, offload=peng, max_slots=3, slot_len=48,
                          eos_id=None, kv_page=16, device="cpu",
                          faults=injector(PF, spec), check_invariants=True)
        steps, dec = [], eng._exec.decode

        def decode(state, tokens, pstate, active, **kw):
            out = dec(state, tokens, pstate, active, **kw)
            steps.append(out[0][torch.as_tensor(active)].clone())  # rows in use
            return out
        eng._exec.decode = decode
        try:
            reqs = [eng.submit(p, n) for p, n in zip(prompts, MAX_NEWS)]
            eng.run(max_steps=400)
        finally:
            del eng._exec.decode
        logits[name] = (steps, [r.generated for r in reqs], eng.stats())
    (a, ta, sa), (b, tb, sb) = logits["pool"], logits["degraded"]
    assert tb == ta and len(a) == len(b)
    worst = max(float((x - y).abs().max()) for x, y in zip(a, b))
    assert worst <= DEGRADED_ATOL, worst
    assert sb["faults_fetch_degraded"] == len(a) * cfg.n_layers
    assert sb["offload_demand_loads"] == 0 < sa["offload_demand_loads"]
