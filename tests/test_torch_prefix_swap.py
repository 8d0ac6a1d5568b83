"""Prefix caching and KV host swap with preemption in the port against
the JAX reference, on ``tiny-moe`` cut to 2 layers, on the CPU, at the
sizes of the reference's ``tests/test_prefix_swap.py``.  Weights are the
reference's seeded ones crossed over by ``repro_torch.bridge``; prompts
are made from a seed with numpy.

* Allocator lockstep: the reference's seeded admit (adopt) / finish
  (insert) / grow / evict schedules driven on the reference's and the
  port's ``PagePool`` + ``PrefixCache`` at once.  After every operation
  the free heaps, refcounts, owned lists, reservations, lookups and
  evicted page ids are equal, and the port's refcounts equal its holder
  counts with a content model: no adopted page holds another prompt's
  block, and a page leaves the model exactly when its last reference
  drops.
* Engine parity, one case per engine test of the reference's file, on the
  same inputs: every request's tokens, the engine step of each token, the
  statuses, prefills skipped, hit tokens, preemptions / resumes /
  recomputes, host swap bytes and the ``stats()`` keys (``kv_*``,
  ``prefix_*``, ``kv_host_*``, ``faults_*``, ``offload_*``) exactly equal
  to the reference's, and the tokens equal to the reference's oracle (B =
  1 ``generate_plain``).  The first difference is named.  The reference's
  runs are shared through a module-scoped fixture.
* The swap round trip restores the gathered pages' bytes exactly, and a
  page the cache still holds is not scrubbed when its slot is released.
* The feature gating, with the reference's messages.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

import parity
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.models import transformer as JT
from repro.serving import kv_manager as JKV
from repro.serving.engine import ContinuousEngine as JContinuous
from repro.serving.prefix_cache import PrefixCache as JPrefix
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.serving import kv_manager as PKV
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.prefix_cache import PrefixCache as PPrefix


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ======================================================================
# allocator lockstep
class _Side:
    """One implementation's PagePool + PrefixCache with a page-content
    model (the reference test's): ``content[pid]`` is the token block a
    page was prefilled from, or ``("tail", slot)`` for a private page."""

    def __init__(self, kv, prefix, n_pages, ps, cache_pages):
        self.ps = ps
        self.pool = kv.PagePool(n_pages, ps)
        self.cache = prefix(ps, cache_pages)
        self.content = {}

    def block(self, prompt, o):
        ps = self.ps
        return np.ascontiguousarray(prompt[o * ps:(o + 1) * ps],
                                    dtype=np.int32).tobytes()

    def free(self, pids):
        freed = [pid for pid in pids if self.pool.decref(pid)]
        for pid in freed:
            del self.content[pid]  # freed: scrubbed before reuse
        return freed

    def release(self, slot):
        freed = self.pool.release(slot)
        for pid in freed:
            del self.content[pid]
        return freed

    def state(self):
        p, c = self.pool, self.cache
        return {"free": list(p._free), "refs": dict(p.refs),
                "owned": {s: list(v) for s, v in p.owned.items()},
                "reserved": dict(p.reserved), "peaks": (p.peak_in_use,
                                                        p.peak_committed),
                "cache": c.stats(), "lookups": c.lookups,
                "cached": sorted(c.pages())}

    def check(self, n_pages):
        expect = {}
        for pids in self.pool.owned.values():
            for pid in pids:
                expect[pid] = expect.get(pid, 0) + 1
        for pid in self.cache.pages():
            expect[pid] = expect.get(pid, 0) + 1
        assert self.pool.refs == expect, "refcounts != holders"
        free, live = set(self.pool._free), set(self.pool.refs)
        assert not free & live and len(free) + len(live) == n_pages
        assert live == set(self.content), "content model out of sync"
        for nd in self.cache._nodes.values():
            assert self.content[nd.page] == nd.key[1], \
                "a cached page's content is not its token block"


def drive_lockstep(n_pages, ps, cache_pages, n_ops, seed):
    rng = random.Random(seed)
    sides = [_Side(JKV, JPrefix, n_pages, ps, cache_pages),
             _Side(PKV, PPrefix, n_pages, ps, cache_pages)]
    prompts = {}
    next_slot = 0

    def both(fn):
        outs = [fn(s) for s in sides]
        assert outs[0] == outs[1], f"op results differ: {outs}"
        return outs[0]

    for i in range(n_ops):
        op = rng.random()
        if op < 0.45 and len(prompts) < 6:
            prompt = np.array([rng.randrange(1, 4) for _ in
                               range(rng.randrange(1, 4 * ps + 1))], np.int32)
            base, pids = both(lambda s: s.cache.lookup(prompt))
            for s in sides:
                for o, pid in enumerate(pids):
                    assert s.content[pid] == s.block(prompt, o), \
                        "adopted another request's divergent page"
            need = len(prompt) + rng.randrange(0, ps + 1)
            ok = both(lambda s: s.pool.can_reserve(
                max(0, s.pool.pages_for(need) - len(pids))))
            if ok:
                slot = next_slot
                next_slot += 1
                n_full = len(prompt) // ps

                def admit(s):
                    s.pool.reserve(slot, need, prealloc_pages=len(pids))
                    s.pool.adopt_shared(slot, pids)
                    new = s.pool.ensure(slot, len(prompt))
                    for pid in new:
                        o = s.pool.owned[slot].index(pid)
                        s.content[pid] = (s.block(prompt, o) if o < n_full
                                          else ("tail", slot))
                    return new
                both(admit)
                prompts[slot] = prompt
        elif op < 0.65 and prompts:
            slot = rng.choice(sorted(prompts))
            prompt = prompts.pop(slot)
            n_full = len(prompt) // ps
            publish = n_full and rng.random() < 0.8

            def finish(s):
                out = None
                if publish:
                    reg, ev = s.cache.insert(prompt, s.pool.owned[slot][:n_full])
                    for pid in reg:  # incref BEFORE freeing the evicted
                        s.pool.incref(pid)
                    out = (reg, ev, s.free(ev))
                return out, s.release(slot)
            both(finish)
        elif op < 0.8 and prompts:
            slot = rng.choice(sorted(prompts))

            def grow(s):
                new = s.pool.ensure(slot, s.pool.reserved[slot] * ps)
                for pid in new:
                    s.content[pid] = ("tail", slot)
                return new
            both(grow)
        else:
            both(lambda s: (lambda ev: (ev, s.free(ev)))(s.cache.evict_lru()))
        for s in sides:
            s.check(n_pages)
        assert sides[0].state() == sides[1].state(), \
            f"allocator state differs after op {i}"
    for slot in list(prompts):
        prompts.pop(slot)
        both(lambda s: s.release(slot))
    while sides[1].cache.n_pages:
        both(lambda s: s.free(s.cache.evict_lru()))
    for s in sides:
        assert s.pool.n_free == n_pages and not s.pool.refs and not s.content
    assert sides[0].state() == sides[1].state()


@pytest.mark.parametrize("n_pages,page_size,cache_pages,n_ops,seed", [
    (8, 2, 4, 120, 0), (6, 1, 3, 100, 1), (16, 4, 8, 150, 2),
    (4, 2, 1, 80, 3), (12, 3, 6, 140, 4), (24, 6, 12, 160, 5),
    (10, 3, 2, 160, 6), (20, 1, 10, 160, 7)])
def test_allocator_lockstep(n_pages, page_size, cache_pages, n_ops, seed):
    drive_lockstep(n_pages, page_size, cache_pages, n_ops, seed)


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
    return jcfg, pcfg, params, pparams


def packed_pair(model, **spec):
    """The reference's packed engine and the port's over its weights."""
    jcfg, pcfg, params, _ = model
    jspec = JSpec(**{**dict(cache_size=2, num_speculative=2, lookahead=1,
                            expert_bits=3, attn_bits=4), **spec})
    jeng = JEngine(params, jcfg, jspec, quantized=True)
    pspec = PSpec(**dataclasses.asdict(jspec))
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    return jeng, PEngine(pp, pcfg, pspec, quantized=True, store=store,
                         device="cpu")


def serve(eng, prompts, news, *, priorities=None, between=None,
          max_steps=800):
    """Submit and drain (calling ``between(eng, reqs)`` after each step);
    returns the record the two packages are held to."""
    steps = {}
    pri = priorities or [0] * len(prompts)
    reqs = [eng.submit(p, m, priority=q, on_token=lambda r, t: steps.setdefault(
        r.rid, []).append(eng.step_count)) for p, m, q in zip(prompts, news, pri)]
    n = 0
    while eng.sched.has_waiting or eng.sched.n_running or eng._swapped:
        eng.step()
        if between is not None:
            between(eng, reqs)
        n += 1
        assert n < max_steps, "engine hung"
    s = eng.stats()
    return {"tokens": [r.generated for r in reqs],
            "steps": [steps.get(r.rid, []) for r in reqs],
            "status": [r.status for r in reqs],
            "prefills_skipped": eng._prefills_skipped,
            "hit_tokens": eng._prefix_hit_tokens,
            "preemptions": eng.sched.preemptions,
            "resumes": eng.sched.resumes, "recomputes": eng._recomputes,
            "host": eng.kv.host_stats() if eng.paged else None,
            "stats": {k: v for k, v in s.items() if not k.startswith("jit_")}}


def first_difference(got, want):
    for key in want:
        if got[key] != want[key]:
            if isinstance(want[key], dict):
                bad = sorted(k for k in set(want[key]) | set(got[key])
                             if got[key].get(k) != want[key].get(k))
                return (f"{key}: " + ", ".join(
                    f"{k} port {got[key].get(k)!r} vs {want[key].get(k)!r}"
                    for k in bad[:6]))
            if isinstance(want[key], list):
                for i, (g, w) in enumerate(zip(got[key], want[key])):
                    if g != w:
                        return f"{key}[request {i}]: port {g} vs {w}"
            return f"{key}: port {got[key]} vs {want[key]}"
    return None


def shared_prefix_prompts(cfg, sys_len, tails, seed=7):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, cfg.vocab_size, sys_len).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(
        1, cfg.vocab_size, int(n)).astype(np.int32)]) for n in tails]


def case_inputs(name, cfg):
    """(prompts, max_news, priorities, engine kwargs, plane) of each of the
    reference's engine tests."""
    tri = parity.make_prompts(cfg, (9, 7, 8), seed=11)
    pre = dict(max_slots=3, slot_len=48, kv_page=4, preemption=True)
    if name == "prefix_hit":
        return (shared_prefix_prompts(cfg, 24, (5, 3, 6)), [6, 5, 4], None,
                dict(max_slots=1, slot_len=64, kv_page=8,
                     prefix_cache_pages=12), "plain")
    if name in ("prefix_packed_cold", "prefix_packed_hit"):
        kw = dict(max_slots=1, slot_len=48, kv_page=8)
        if name.endswith("hit"):
            kw["prefix_cache_pages"] = 8
        return (shared_prefix_prompts(cfg, 16, (4, 6, 3), seed=13),
                [5, 6, 4], None, kw, "packed")
    if name == "swap_resume":
        return tri, [8] * 3, [0, 0, 5], dict(pre, kv_host_pages=8,
                                             kv_pages_total=10), "plain"
    if name == "recompute_resume":
        return tri, [8] * 3, [0, 0, 5], dict(pre, kv_host_pages=0,
                                             kv_pages_total=10), "plain"
    if name == "priority_admission":
        return tri, [8] * 3, [0, 0, 5], dict(pre, kv_host_pages=8,
                                             kv_pages_total=6), "plain"
    if name == "serialized_exhaustion":
        return (parity.make_prompts(cfg, (9, 8, 7), seed=5), [8] * 3, None,
                dict(max_slots=3, slot_len=48, kv_page=4, kv_pages_total=5,
                     prefix_cache_pages=4), "plain")
    if name == "eviction_reuse":
        a = shared_prefix_prompts(cfg, 20, (4,))[0]
        b = parity.make_prompts(cfg, (23,), seed=99)[0]
        return ([a, b, a], [6] * 3, None,
                dict(max_slots=1, slot_len=64, kv_page=8,
                     prefix_cache_pages=1), "plain")
    if name == "swap_resume_packed":
        return tri, [8] * 3, [0, 0, 5], dict(pre, kv_host_pages=8,
                                             kv_pages_total=10), "packed"
    raise KeyError(name)


CASES = ("prefix_hit", "prefix_packed_cold", "prefix_packed_hit",
         "swap_resume", "recompute_resume", "priority_admission",
         "serialized_exhaustion", "eviction_reuse", "swap_resume_packed")


@pytest.fixture(scope="module")
def packed(model):
    # the reference's counter-parity test: the pool holds every expert
    return packed_pair(model, cache_size=8, num_speculative=0)


@pytest.fixture(scope="module")
def reference_runs(model, packed):
    """The reference's record of every case, and its oracle streams."""
    jcfg, _, params, _ = model
    jeng = packed[0]
    out = {}
    for name in CASES:
        prompts, news, pri, kw, plane = case_inputs(name, jcfg)
        eng = JContinuous(params if plane == "plain" else None, jcfg,
                          eos_id=None, offload=jeng if plane == "packed"
                          else None, **kw)
        out[name] = serve(eng, prompts, news, priorities=pri)
    return out


@pytest.mark.parametrize("name", CASES)
def test_engine_matches_reference(name, model, packed, reference_runs):
    jcfg, pcfg, params, pparams = model
    prompts, news, pri, kw, plane = case_inputs(name, jcfg)
    eng = PContinuous(pparams if plane == "plain" else None, pcfg,
                      eos_id=None, offload=packed[1] if plane == "packed"
                      else None, device="cpu", check_invariants=True, **kw)
    got = serve(eng, prompts, news, priorities=pri)
    want = reference_runs[name]
    diff = first_difference(got, want)
    assert diff is None, f"{name}: {diff}"
    if plane == "plain":  # the reference's oracle
        parity.assert_tokens_equal(
            got["tokens"], parity.oracle_streams(params, jcfg, prompts, news),
            name)
    eng.check_invariants()
    cached = eng._prefix.n_pages if eng._prefix is not None else 0
    assert eng.kv.pool.n_free + cached == eng.kv.pool.n_pages


def test_engine_cases_exercise_their_paths(reference_runs):
    """What each case is for happened (the reference's own asserts)."""
    r = reference_runs
    assert r["prefix_hit"]["prefills_skipped"] == 2
    assert r["prefix_hit"]["hit_tokens"] == 48
    assert r["prefix_packed_hit"]["prefills_skipped"] == 2
    assert r["prefix_packed_hit"]["tokens"] == r["prefix_packed_cold"]["tokens"]
    keys = ("offload_demand_loads", "offload_spec_loads", "offload_bytes_h2d")
    assert ({k: r["prefix_packed_hit"]["stats"][k] for k in keys}
            == {k: r["prefix_packed_cold"]["stats"][k] for k in keys})
    for name in ("swap_resume", "swap_resume_packed"):
        assert r[name]["preemptions"] >= 1 and r[name]["recomputes"] == 0
        assert r[name]["host"]["swap_out_bytes"] == \
            r[name]["host"]["swap_in_bytes"] > 0
    assert r["recompute_resume"]["recomputes"] == \
        r["recompute_resume"]["resumes"] >= 1
    assert r["priority_admission"]["preemptions"] >= 1
    assert r["serialized_exhaustion"]["preemptions"] == 0
    assert r["eviction_reuse"]["stats"]["prefix_evicted_pages"] > 0


# ======================================================================
# the device-side pieces: swap round trip, shared pages kept
def test_swap_round_trip_restores_pages_exactly(model):
    """A slot's pages staged out and back into other page ids: every
    layer's kp/vp/ppos bytes equal, positions and length restored, the
    host pool's bytes counted both ways."""
    _, pcfg, _, _ = model
    kv = PKV.PagedKVManager(pcfg, 2, 4, 12, 6, device="cpu")
    kv.enable_host_swap(8)
    gen = torch.Generator().manual_seed(0)
    for blk in kv.state["layers"]:
        for name in ("kp", "vp"):
            blk["kv"][name].copy_(torch.randn(blk["kv"][name].shape,
                                              generator=gen))
        blk["kv"]["ppos"].copy_(torch.arange(blk["kv"]["ppos"].numel(),
                                             dtype=torch.int32
                                             ).reshape(blk["kv"]["ppos"].shape))
    other = kv.allocate("other", 8)
    kv.ensure(other, 8)
    slot = kv.allocate("r", 20)
    kv.ensure(slot, 11)
    kv.note_tokens(slot, 11)
    pids = list(kv.pool.owned[slot])
    want = [{n: blk["kv"][n][pids].clone() for n in ("kp", "vp", "ppos")}
            for blk in kv.state["layers"]]
    blob = kv.swap_out(slot)
    kv.release(slot)
    kv.release(other)
    kv.ensure(kv.allocate("x", 4), 4)  # the old pages go to someone else
    slot = kv.swap_in("r", blob, 12)
    new = list(kv.pool.owned[slot])
    assert new != pids and len(new) == len(pids) == blob["n_pages"]
    for blk, w in zip(kv.state["layers"], want):
        for n in ("kp", "vp", "ppos"):
            assert torch.equal(blk["kv"][n][new], w[n]), n
    assert kv.length(slot) == 11 and kv.state["pos"][slot] == 11
    hs = kv.host_stats()
    assert hs["swap_out_bytes"] == hs["swap_in_bytes"] == \
        3 * kv.page_nbytes() and hs["pages_in_use"] == 0
    kv.check_invariants()


def test_release_keeps_cache_held_pages_unscrubbed(model):
    """A slot sharing a cached page releases it without scrubbing: only
    the pages whose last reference dropped get ``ppos`` -1."""
    _, pcfg, _, _ = model
    kv = PKV.PagedKVManager(pcfg, 2, 4, 8, 4, device="cpu")
    a = kv.allocate("a", 12)
    kv.ensure(a, 12)
    for blk in kv.state["layers"]:
        blk["kv"]["ppos"][:] = 7
    shared = list(kv.pool.owned[a][:2])
    for pid in shared:
        kv.pool.incref(pid)  # the cache's reference
    b = kv.allocate("b", 12, shared_pages=shared, base=8)
    kv.ensure(b, 12)
    assert list(kv._pages_np[b, :3]) == shared + [kv.pool.owned[b][2]]
    freed = {kv.pool.owned[a][2], kv.pool.owned[b][2]}
    kv.release(a)
    kv.release(b)
    for blk in kv.state["layers"]:
        pp = blk["kv"]["ppos"]
        for pid in range(8):
            assert bool((pp[pid] == -1).all()) == (pid in freed), pid
    kv.check_invariants(cache_pages=shared)
    assert kv.free_cached_pages(shared) == shared
    assert bool((kv.state["layers"][0]["kv"]["ppos"][:4] == -1).all())


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache_pages=4), "block-paged"),
    (dict(preemption=True), "block-paged"),
    (dict(kv_page=8, kv_host_pages=4), "preemption"),
    (dict(kv_page=8, preemption=True, num_draft_tokens=2),
     "draft-and-verify")], ids=["prefix", "preempt", "host", "drafts"])
def test_feature_gating(model, kw, match):
    jcfg, pcfg, params, pparams = model
    with pytest.raises(ValueError, match=match):
        JContinuous(params, jcfg, max_slots=1, slot_len=32, **kw)
    with pytest.raises(ValueError, match=match):
        PContinuous(pparams, pcfg, max_slots=1, slot_len=32, device="cpu",
                    **kw)


def test_submit_refuses_what_no_preemption_can_fit(model):
    jcfg, pcfg, params, pparams = model
    prompt = parity.make_prompts(jcfg, (9,))[0]
    kw = dict(max_slots=2, slot_len=64, kv_page=4, kv_pages_total=4,
              preemption=True)
    for eng in (JContinuous(params, jcfg, **kw),
                PContinuous(pparams, pcfg, device="cpu", **kw)):
        with pytest.raises(ValueError, match="even preemption"):
            eng.submit(prompt, 8)
