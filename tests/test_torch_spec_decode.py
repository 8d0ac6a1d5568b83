"""Draft-and-verify decoding in the port against the JAX reference, on
``tiny-moe`` cut to 2 layers with the ``tiny-draft`` draft, on the CPU.
Weights are the reference's seeded ones crossed over by
``repro_torch.bridge``; prompts are made from a seed with numpy.

* The acceptance rule: the reference's fallback cases and a hypothesis
  property, the port's ``accept_length``/``verify_round`` equal to the
  reference's on random sequences.
* Rollback: ``KVSlotManager.truncate`` is a position reset only;
  ``PagePool.trim`` and ``PagedKVManager.truncate`` then regrowth leave
  the page table, the free heap and the scrubbed ``ppos`` equal to the
  reference's after a fixed script.
* Verify chunks through the executor: packed ``Executor.decode`` at C = 4
  in lock-step on the pipelined and unrolled planes (the vectorized
  plane differs from the pipelined one only in where it stages, and
  stages nothing at C > 1) and at B = 3, C = 3 on pages
  with inactive rows, against the reference's: logits within
  ``LOGIT_ATOL`` (f32), route ids and the pool's counters and LRU state
  exactly equal; the per-row dense-ring chunk of ``layers`` against the
  reference's per-row ``attention_decode`` (``KV_ATOL``), including
  entries a rollback left past a row's position.
* ``OffloadEngine`` on ``packed_pipelined``, ``packed_vectorized``,
  ``packed_sync`` and accounting, for the dense draft and replay drafts
  at acceptance 1.0 and with every third proposal missed (K = 3), and at
  k = 1: tokens equal to the port's non-speculative greedy and to the
  reference's speculative tokens; ``OffloadStats`` and the speculation
  totals equal to the reference's; at acceptance 1.0 no more h2d bytes
  than the baseline.
* ``ContinuousEngine`` with the dense draft on the plain plane (dense,
  paged, paged exact, paged chunked, and k = 1 on dense)
  and offloaded (``{}``, ``kv_page=16``, ``prefill_chunk=4``): tokens and
  rounds equal to the reference's, tokens equal to the non-speculative
  run's, the audit clean.
* The guards, with the reference's messages, and the port's
  ``offload_bench`` speculative scenario at its smoke size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import parity
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core import draft as JD
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.core.offload_engine import quantize_for_offload as jquantize
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import kv_manager as JKV
from repro.serving.engine import ContinuousEngine as JContinuous
from repro_torch import bridge
from repro_torch.benchmarks import offload_bench
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import draft as PD
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.runtime.executor import Executor
from repro_torch.serving import kv_manager as PKV
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.sampler import SamplerConfig as PSampler

K = 3               # draft tokens per round, as in the reference's matrix
MAX_NEW = 10
LOGIT_ATOL = 1e-5   # f32 logits of the same products summed in another order
KV_ATOL = 1e-5
PLANES = {"packed_pipelined": dict(quantized=True),
          "packed_vectorized": dict(quantized=True, pipelined=False),
          "packed_sync": dict(quantized=True, pipelined=False,
                              vectorized=False),
          "accounting": dict(quantized=False)}
DRAFTS = ("dense", "replay_hit", "replay_miss3")
CONTINUOUS = ("dense", "paged", "paged_exact", "paged_chunked")
OFFLOADED = {"dense": {}, "paged": dict(kv_page=16),
             "chunked": dict(prefill_chunk=4)}
COUNTERS = ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


def cross(tree, cfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    jdcfg, pdcfg = jget("tiny-draft"), pget("tiny-draft")
    params = JT.init_model(jax.random.key(0), jcfg)
    dparams = JT.init_model(jax.random.key(7), jdcfg)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, pp=cross(params, pcfg),
                jdcfg=jdcfg, pdcfg=pdcfg, dparams=dparams,
                pdp=cross(dparams, pdcfg))


@pytest.fixture(scope="module")
def offload(model):
    """Each package's engine on the four planes over the same bytes: the
    reference quantizes once; its packed weights and store, and its
    dequantized model for accounting, cross into the port."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    jspec = JSpec(cache_size=4, num_speculative=2, lookahead=1,
                  expert_bits=3, attn_bits=4)
    pspec = PSpec(**dataclasses.asdict(jspec))
    qdeq = jquantize(model["params"], jcfg, jspec)[0]
    jeng = JEngine(model["params"], jcfg, jspec, quantized=True)
    pparams = cross(jeng.params, pcfg)
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    jengs = {"packed_pipelined": jeng,
             "packed_vectorized": JEngine(model["params"], jcfg, jspec,
                                          quantized=True, pipelined=False),
             "packed_sync": JEngine(model["params"], jcfg, jspec,
                                    quantized=True, pipelined=False,
                                    vectorized=False),
             "accounting": JEngine(qdeq, jcfg, jspec, quantized=False)}
    pengs = {}
    for name, kw in PLANES.items():
        if kw["quantized"]:
            pengs[name] = PEngine(pparams, pcfg, pspec, store=store,
                                  device="cpu", **kw)
        else:
            pengs[name] = PEngine(cross(qdeq, pcfg), pcfg, pspec,
                                  device="cpu")
    prompt = parity.make_prompts(jcfg, (9,), seed=3)[0][None]
    return dict(jspec=jspec, pspec=pspec, jengs=jengs, pengs=pengs,
                prompt=prompt, pparams=pparams, store=store)


# ----------------------------------------------------------------------
# the acceptance rule
ACCEPT_CASES = [([], [9]), ([5], [5, 7]), ([5], [6, 7]),
                ([1, 2, 3], [1, 2, 3, 4]), ([1, 2, 3], [1, 2, 9, 4]),
                ([0, 0, 0, 0], [0, 0, 0, 0, 0]),
                ([3, 1, 4, 1, 5], [3, 1, 4, 2, 5, 9])]


def check_acceptance(draft, target):
    a = PD.accept_length(draft, target)
    assert a == JD.accept_length(draft, target)
    assert PD.verify_round(draft, target) == JD.verify_round(draft, target)
    emitted, a2 = PD.verify_round(draft, target)
    assert a2 == a and emitted == [int(t) for t in target[: a + 1]]
    if a < len(draft):
        assert int(draft[a]) != int(target[a])


@pytest.mark.parametrize("case", ACCEPT_CASES, ids=str)
def test_acceptance_rule_cases(case):
    check_acceptance(*case)


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 8).flatmap(
    lambda k: st.tuples(st.lists(st.integers(0, 5), min_size=k, max_size=k),
                        st.lists(st.integers(0, 5), min_size=k + 1,
                                 max_size=k + 1))))
def test_acceptance_rule_property(case):
    check_acceptance(*case)


# ----------------------------------------------------------------------
# rollback
def test_dense_truncate_is_a_position_reset(model):
    kv = PKV.KVSlotManager(model["pcfg"], 2, 32, device="cpu")
    s = kv.allocate("r")
    pos = kv.state["pos"].copy()
    pos[s] = 19
    kv.state = dict(kv.state, pos=pos)
    before = [{k: v.clone() for k, v in blk["kv"].items()}
              for blk in kv.state["layers"]]
    kv.truncate(s, 12)
    assert kv.state["pos"].tolist() == [12, 0]
    for blk, old in zip(kv.state["layers"], before):
        for k, v in old.items():
            assert torch.equal(blk["kv"][k], v)
    with pytest.raises(AssertionError):
        kv.truncate(s, 13)


def test_paged_truncate_and_regrow_match_reference(model):
    """A fixed script of ensure / write / truncate / ensure on two slots:
    the page table, the pool's owned lists and free heap, the positions,
    and every layer's ``ppos`` (written through real decode steps, freed
    pages scrubbed) equal the reference's after each action."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    jm = JKV.PagedKVManager(jcfg, 2, 4, 16, 8)
    pm = PKV.PagedKVManager(pcfg, 2, 4, 16, 8, device="cpu")
    slots = [(jm.allocate("a", n_tokens=30), pm.allocate("a", n_tokens=30)),
             (jm.allocate("b", n_tokens=20), pm.allocate("b", n_tokens=20))]
    assert [a for a, _ in slots] == [b for _, b in slots]

    def write(s, lo, hi):
        """A row chunk of the tokens at positions lo..hi-1 of slot s (its
        position is lo: every write starts at the slot's length)."""
        tok = np.arange(lo, hi, dtype=np.int32)[None] % 500 + 1
        jm.ensure(s, hi)
        pm.ensure(s, hi)
        _, jst = JT.decode_step(model["params"], jcfg, jm.view(),
                                jnp.asarray(tok), moe_mode="gather", row=s)
        _, pst = PT.decode_step(model["pp"], pcfg, pm.view(),
                                torch.from_numpy(tok), row=s)
        jm.adopt(jst)
        pm.adopt(pst)
        jm.note_tokens(s, hi)
        pm.note_tokens(s, hi)

    def same():
        np.testing.assert_array_equal(pm._pages_np, np.asarray(jm._pages_np))
        assert sorted(pm.pool._free) == sorted(jm.pool._free)
        assert list(pm.pool._free) == list(jm.pool._free)
        assert pm.pool.owned == jm.pool.owned
        assert pm.pool.reserved == jm.pool.reserved
        assert pm._len == jm._len
        np.testing.assert_array_equal(pm.state["pos"],
                                      np.asarray(jm.state["pos"]))
        for l, blk in enumerate(pm.state["layers"]):
            np.testing.assert_array_equal(
                blk["kv"]["ppos"].numpy(),
                np.asarray(jm.state["stack"][0]["kv"]["ppos"][l]))
        pm.check_invariants()

    (a, _), (b, _) = slots
    script = [("write", a, 0, 9), ("write", b, 0, 5), ("write", a, 9, 23),
              ("truncate", a, 14), ("write", b, 5, 13), ("truncate", b, 6),
              ("write", a, 14, 27), ("truncate", a, 3), ("write", b, 6, 17),
              ("write", a, 3, 12), ("truncate", b, 16)]
    for act, s, *args in script:
        if act == "write":
            write(s, *args)
        else:
            jm.truncate(s, *args)
            pm.truncate(s, *args)
        same()
    with pytest.raises(AssertionError):
        pm.truncate(a, 13)


@pytest.mark.parametrize("lengths", [(7, 3, 9, 1, 12), (5, 5, 2, 9, 9, 1),
                                     (10, 2, 17, 16, 3)])
def test_page_pool_trim_matches_reference(lengths):
    jp, pp = JKV.PagePool(8, 4), PKV.PagePool(8, 4)
    for pool in (jp, pp):
        pool.reserve("r", max(lengths))
    cur = 0
    for n in lengths:
        if n >= cur:
            assert pp.ensure("r", n) == jp.ensure("r", n)
        else:
            assert pp.trim("r", n) == jp.trim("r", n)
        cur = n
        assert pp.owned == jp.owned and list(pp._free) == list(jp._free)
        assert len(pp.owned["r"]) == pp.pages_for(cur)
        assert "r" in pp.reserved
    assert pp.release("r") == jp.release("r")


# ----------------------------------------------------------------------
# verify chunks through the executor
def _pool_equal(pps, jps):
    np.testing.assert_array_equal(pps.counts, np.asarray(jps.counts))
    np.testing.assert_array_equal(np.stack([s.cache_ids for s in pps.lru]),
                                  np.asarray(jps.lru.cache_ids))
    np.testing.assert_array_equal(np.stack([s.spec_ids for s in pps.lru]),
                                  np.asarray(jps.lru.spec_ids))


@pytest.mark.parametrize("plane", ["packed_pipelined", "packed_sync"])
def test_packed_verify_chunk_matches_reference(offload, plane):
    """Batch 1 in lock-step: a prompt prefill, a C = 1 step, then two C =
    4 chunks, the second after a rollback of two positions (the entries
    past the position stay in the ring)."""
    jeng, peng = offload["jengs"][plane], offload["pengs"][plane]
    jdec, pdec = jeng._decoder, peng._exec
    prompt = offload["prompt"]
    S = prompt.shape[1]
    jps, pps = jdec.init_pool_state(), pdec.init_pool_state(max_rows=4)
    _, jst, _ = jdec.prefill(jnp.asarray(prompt), S + 16)
    _, pst = pdec.prefill(torch.from_numpy(prompt), S + 16)
    rng = np.random.default_rng(5)
    for C, rollback in ((1, 0), (4, 2), (4, 1)):
        tok = rng.integers(1, 500, (1, C)).astype(np.int32)
        jlog, jst, jps, jids = jdec.decode(jst, jnp.asarray(tok), jps)
        plog, pst, pps, pids = pdec.decode(pst, tok, pps)
        assert plog.shape[:2] == (1, C)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=LOGIT_ATOL)
        for a, b in zip(jids, pids):
            np.testing.assert_array_equal(b, np.asarray(a))
        _pool_equal(pps, jps)
        jst = dict(jst, pos=jst["pos"] - rollback)
        pst = dict(pst, pos=pst["pos"] - rollback)
    assert EP.pool_coherent(peng.store, pps)
    assert pps.h2d_bytes == (pps.counts[2] + pps.counts[3]) * peng.expert_bytes


def test_packed_paged_rows_of_chunks_match_reference(model, offload):
    """B = 3 rows of C = 3 tokens on pages with inactive rows, on the
    pipelined plane: the route ids of the active rows' token rows, their
    logits, the pool's counters and LRU state and every ``ppos`` equal
    the reference's; an inactive row writes nothing and stays."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    jdec = offload["jengs"]["packed_pipelined"]._decoder
    pdec = offload["pengs"]["packed_pipelined"]._exec
    B, P, ps, T = 3, 12, 4, 5
    jst = JT.init_decode_state(jcfg, B, T * ps, kv_pages=P, kv_page=ps,
                               kv_max_pages=T)
    pst = PT.init_decode_state(pcfg, B, T * ps, "cpu", kv_pages=P,
                               kv_page=ps, kv_max_pages=T)
    pages = np.full((B, T), -1, np.int32)
    pages[0, :4], pages[1, :3], pages[2, :5] = [3, 7, 0, 6], [5, 1, 8], \
        [2, 9, 4, 11, 10]
    jst = dict(jst, pages=jnp.asarray(pages), pos=jnp.zeros(B, jnp.int32))
    pst = dict(pst, pages=pages, pos=np.zeros(B, np.int32))
    rng = np.random.default_rng(4)
    for slot, n in ((0, 6), (1, 4), (2, 7)):
        tok = rng.integers(1, 500, (1, n)).astype(np.int32)
        _, jst = jdec.prefill_chunk_row(jst, jnp.asarray(tok), slot)
        _, pst = pdec.prefill_chunk_row(pst, tok, slot)
    jps, pps = jdec.init_pool_state(), pdec.init_pool_state(max_rows=B * 3)
    for active, rollback in (([True, True, True], [2, 0, 1]),
                             ([True, False, True], [0, 0, 2]),
                             ([False, True, True], [1, 2, 0])):
        act = np.asarray(active)
        tok = rng.integers(1, 500, (B, 3)).astype(np.int32)
        jlog, jst, jps, jids = jdec.decode(jst, jnp.asarray(tok), jps,
                                           jnp.asarray(act))
        plog, pst, pps, pids = pdec.decode(pst, tok, pps, act)
        np.testing.assert_allclose(plog.numpy()[act], np.asarray(jlog)[act],
                                   rtol=0, atol=LOGIT_ATOL)
        rows = (np.flatnonzero(act)[:, None] * 3 + np.arange(3)).ravel()
        for a, b in zip(jids, pids):
            np.testing.assert_array_equal(b[rows], np.asarray(a)[rows])
        _pool_equal(pps, jps)
        np.testing.assert_array_equal(pst["pos"], np.asarray(jst["pos"]))
        for l, blk in enumerate(pst["layers"]):
            np.testing.assert_array_equal(
                blk["kv"]["ppos"].numpy(),
                np.asarray(jst["stack"][0]["kv"]["ppos"][l]))
        back = np.asarray(rollback, np.int32) * act
        jst = dict(jst, pos=jst["pos"] - jnp.asarray(back))
        pst = dict(pst, pos=(pst["pos"] - back).astype(np.int32))


def test_per_row_ring_chunks_match_reference(model):
    """Per-row dense-ring chunks of C = 3 (the continuous engine's verify
    rows) at rows' own positions, with rollbacks in between: outputs, ring
    contents and ring positions against the reference's per-row
    ``attention_decode``."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    p = JT.layer_params(model["params"], jcfg, 0)["attn"]
    pp = model["pp"]["layers"][0]["attn"]
    B, W, C = 3, 32, 3
    jc = JL.init_attn_cache(jcfg, B, W)
    pc = PL.init_attn_cache(pcfg, B, W, "cpu")
    pos = np.asarray([0, 4, 9], np.int32)
    rng = np.random.default_rng(2)
    for back in ([0, 0, 0], [2, 0, 1], [1, 2, 2], [0, 1, 0]):
        x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
        yj, jc = JL.attention_decode(p, jcfg, jnp.asarray(x), jc,
                                     jnp.asarray(pos))
        step = PL.ring_step(pos, C, torch.device("cpu"))
        yp, pc = PL.attention_decode(pp, pcfg, torch.from_numpy(x), pc, None,
                                     step=step)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0,
                                   atol=KV_ATOL)
        np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=0, atol=KV_ATOL)
        pos = pos + C - np.asarray(back, np.int32)


# ----------------------------------------------------------------------
# OffloadEngine
def _drafts(model, ref, side):
    cfg = model["jcfg"]
    if side == "ref":
        return {"dense": lambda: JD.DenseDraft(model["dparams"],
                                               model["jdcfg"]),
                "replay_hit": lambda: JD.ReplayDraft(
                    ref, vocab_size=cfg.vocab_size),
                "replay_miss3": lambda: JD.ReplayDraft(
                    ref, miss_every=3, vocab_size=cfg.vocab_size)}
    return {"dense": lambda: PD.DenseDraft(model["pdp"], model["pdcfg"],
                                           device="cpu"),
            "replay_hit": lambda: PD.ReplayDraft(ref,
                                                 vocab_size=cfg.vocab_size),
            "replay_miss3": lambda: PD.ReplayDraft(
                ref, miss_every=3, vocab_size=cfg.vocab_size)}


@pytest.fixture(scope="module")
def offload_runs(model, offload):
    """Per plane: the baseline of both packages, then each draft at K and
    the hit replay at k = 1, on the same engines in the same order."""
    prompt = offload["prompt"]
    out = {}
    for plane in PLANES:
        jeng, peng = offload["jengs"][plane], offload["pengs"][plane]
        jbase = jeng.generate(prompt, MAX_NEW)
        pbase = peng.generate(prompt, MAX_NEW)
        ref = np.concatenate([prompt[0], np.asarray(jbase[0])[0]])
        jd, pd = _drafts(model, ref, "ref"), _drafts(model, ref, "port")
        runs = {}
        k1 = [("replay_hit_k1", 1)] if plane == "packed_pipelined" else []
        for name, k in [(d, K) for d in DRAFTS] + k1:
            d = name.replace("_k1", "")
            jm0 = (jeng._spec_metrics.rounds.value
                   if jeng._spec_metrics is not None else 0)
            jr = jeng.generate(prompt, MAX_NEW, draft=jd[d](),
                               num_draft_tokens=k)
            pm0 = peng.spec_metrics.rounds
            pr = peng.generate(prompt, MAX_NEW, draft=pd[d](),
                               num_draft_tokens=k)
            runs[name] = (jr, pr, jeng._spec_metrics.rounds.value - jm0,
                          peng.spec_metrics.rounds - pm0,
                          peng._last_pool_state)
        out[plane] = dict(jbase=jbase, pbase=pbase, runs=runs,
                          jspec=jeng.obs.snapshot()["spec"],
                          pspec=peng.spec_metrics)
    return out


@pytest.mark.parametrize("plane,draft",
                         [(p, d) for p in PLANES for d in DRAFTS]
                         + [("packed_pipelined", "replay_hit_k1")])
def test_offload_speculative_matches_reference(offload_runs, plane, draft):
    r = offload_runs[plane]
    (jt, js), (pt, ps), jrounds, prounds, _ = r["runs"][draft]
    np.testing.assert_array_equal(pt, r["pbase"][0])
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(r["pbase"][0], np.asarray(r["jbase"][0]))
    for f in COUNTERS:
        assert getattr(ps, f) == getattr(js, f), f
    assert ps.bytes_h2d == js.bytes_h2d
    assert prounds == jrounds > 0
    if draft.startswith("replay_hit"):
        assert ps.bytes_h2d <= r["pbase"][1].bytes_h2d


@pytest.mark.parametrize("plane", list(PLANES))
def test_offload_spec_totals_match_reference(offload_runs, plane):
    """The speculation totals over the plane's runs against the
    reference's ``obs.snapshot()["spec"]``."""
    j, p = offload_runs[plane]["jspec"], offload_runs[plane]["pspec"]
    assert p.rounds == j["rounds"] == j["proposed"]["count"]
    assert p.proposed_total == j["proposed"]["sum"]
    assert p.accepted_total == j["accepted"]["sum"]
    assert p.proposed.min == j["proposed"]["min"]
    assert p.accepted.max == j["accepted"]["max"]
    assert p.acceptance_rate == pytest.approx(j["acceptance_rate"], rel=1e-12)
    assert p.bytes_h2d_per_accepted == pytest.approx(
        j["bytes_h2d_per_accepted"], rel=1e-12)


@pytest.mark.parametrize("plane", ["packed_pipelined", "packed_vectorized",
                                   "packed_sync"])
def test_packed_h2d_bytes_issued_equal_counters(offload_runs, offload,
                                                plane):
    """Every speculative run's h2d copies issued are what its counters
    charge, and its pool ends coherent."""
    store = offload["pengs"][plane].store
    for name, (_, (_, stats), _, _, ps) in offload_runs[plane]["runs"].items():
        assert ps.h2d_bytes == stats.bytes_h2d, name
        assert EP.pool_coherent(store, ps), name


# ----------------------------------------------------------------------
# ContinuousEngine
PROMPT_LENS, MAX_NEWS = (5, 11, 3, 8), [6, 4, 8, 5]


def _serve(cls, params, cfg, prompts, max_news, **kw):
    eng = cls(params, cfg, max_slots=2, slot_len=64, eos_id=None, **kw)
    reqs = [eng.submit(p, m) for p, m in zip(prompts, max_news)]
    eng.run(max_steps=400)
    assert all(r.state == "finished" for r in reqs)
    return [list(map(int, r.generated)) for r in reqs], eng


@pytest.fixture(scope="module")
def continuous(model):
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    prompts = parity.make_prompts(jcfg, PROMPT_LENS, seed=21)
    base, _ = _serve(PContinuous, model["pp"], pcfg, prompts, MAX_NEWS,
                     device="cpu")
    return prompts, base


def _spec_kw(model, side, k=K):
    if side == "ref":
        return dict(draft_params=model["dparams"], draft_cfg=model["jdcfg"],
                    num_draft_tokens=k)
    return dict(draft_params=model["pdp"], draft_cfg=model["pdcfg"],
                num_draft_tokens=k, device="cpu")


@pytest.mark.parametrize("variant,k", [(v, K) for v in CONTINUOUS]
                         + [("dense", 1)],
                         ids=list(CONTINUOUS) + ["dense-k1"])
def test_continuous_speculative_matches_reference(model, continuous,
                                                  variant, k):
    prompts, base = continuous
    kw = parity.CONTINUOUS_KV_VARIANTS[variant]
    jt, jeng = _serve(JContinuous, model["params"], model["jcfg"], prompts,
                      MAX_NEWS, **kw, **_spec_kw(model, "ref", k))
    pt, peng = _serve(PContinuous, model["pp"], model["pcfg"], prompts,
                      MAX_NEWS, **kw, **_spec_kw(model, "port", k))
    assert pt == jt
    assert pt == base
    j = jeng.obs.snapshot()["spec"]
    assert peng.spec_metrics.rounds == j["rounds"] > 0
    assert peng.spec_metrics.accepted_total == j["accepted"]["sum"]
    assert peng.step_count == jeng.step_count
    peng.check_invariants()
    assert peng.kv.n_free == 2
    if "pages" in peng.kv.state:
        assert peng.kv.pool.n_free == peng.kv.pool.n_pages


@pytest.fixture(scope="module")
def offloaded(offload):
    """The pipelined engines of ``offload`` (cache 4, 3-bit experts, the
    reference's offloaded continuous spec) and the port's non-speculative
    run of the requests."""
    jeng = offload["jengs"]["packed_pipelined"]
    peng = offload["pengs"]["packed_pipelined"]
    prompts = parity.make_prompts(jeng.cfg, (5, 8, 6), seed=33)
    news = [5, 7, 4]
    base, _ = _serve(PContinuous, None, peng.cfg, prompts, news, offload=peng)
    return jeng, peng, prompts, news, base


@pytest.mark.parametrize("variant", list(OFFLOADED))
def test_offloaded_continuous_speculative_matches_reference(model, offloaded,
                                                            variant):
    jeng, peng, prompts, news, base = offloaded
    kw = OFFLOADED[variant]
    jt, jce = _serve(JContinuous, None, model["jcfg"], prompts, news,
                     offload=jeng, **kw, **_spec_kw(model, "ref"))
    pt, pce = _serve(PContinuous, None, model["pcfg"], prompts, news,
                     offload=peng, **kw,
                     **{k: v for k, v in _spec_kw(model, "port").items()
                        if k != "device"})
    assert pt == jt
    assert pt == base
    j = jce.obs.snapshot()["spec"]
    assert pce.spec_metrics.rounds == j["rounds"] > 0
    ps, js = pce.stats(), jce.stats()
    for key in ("offload_hits", "offload_spec_hits", "offload_demand_loads",
                "offload_spec_loads", "offload_bytes_h2d"):
        assert ps[key] == js[key], key
    assert pce.spec_metrics.bytes_h2d_per_accepted == pytest.approx(
        j["bytes_h2d_per_accepted"], rel=1e-12)
    assert pce._pstate.h2d_bytes == ps["offload_bytes_h2d"]
    pce.check_invariants()


def test_cancel_unbinds_the_draft_row(model):
    pcfg = model["pcfg"]
    eng = PContinuous(model["pp"], pcfg, max_slots=2, slot_len=64,
                      eos_id=None, **_spec_kw(model, "port"))
    prompts = parity.make_prompts(model["jcfg"], (5, 7), seed=1)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.step()
    eng.step()
    slot = reqs[0].slot
    assert eng._draft_rid[slot] == reqs[0].rid
    assert eng.cancel(reqs[0].rid)
    assert eng._draft_rid[slot] == -1
    eng.run(max_steps=50)
    assert reqs[0].status == "cancelled" and reqs[1].status == "completed"
    eng.check_invariants()


# ----------------------------------------------------------------------
# guards
def test_speculation_guards(model):
    pcfg, pp = model["pcfg"], model["pp"]
    dp, dcfg = model["pdp"], model["pdcfg"]
    with pytest.raises(ValueError, match="draft_params"):
        PContinuous(pp, pcfg, max_slots=1, slot_len=32, num_draft_tokens=2,
                    device="cpu")
    bad = dataclasses.replace(dcfg, vocab_size=pcfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        PContinuous(pp, pcfg, max_slots=1, slot_len=32, draft_params=dp,
                    draft_cfg=bad, num_draft_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        PContinuous(pp, pcfg, max_slots=1, slot_len=32,
                    sampler=PSampler(kind="categorical"), draft_params=dp,
                    draft_cfg=dcfg, num_draft_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        PContinuous(pp, pcfg, max_slots=1, slot_len=32, draft_params=pp,
                    draft_cfg=pcfg, num_draft_tokens=2, device="cpu")
    eng = PEngine(pp, pcfg, device="cpu")
    prompt = parity.make_prompts(model["jcfg"], (5,), seed=1)[0][None]
    with pytest.raises(ValueError, match="greedy"):
        eng.generate(prompt, 4, greedy=False,
                     draft=PD.DenseDraft(dp, dcfg, device="cpu"),
                     num_draft_tokens=2)
    with pytest.raises(ValueError, match="dense"):
        PD.DenseDraft(pp, pcfg, device="cpu")
    assert PD.make_draft(None) is None
    made = PD.make_draft("tiny-draft", seed=7, device="cpu")
    assert isinstance(made, PD.DenseDraft) and made.cfg == dcfg


def test_swa_ring_cap(model):
    """tiny-moe is all SWA (window 256): dense slots wider than the window
    would wrap, so a speculative engine caps requests at min(slot_len,
    window), and the batch-1 engine refuses a request past the window."""
    pcfg, pp = model["pcfg"], model["pp"]
    win = pcfg.sliding_window
    eng = PContinuous(pp, pcfg, max_slots=1, slot_len=win + 44,
                      **_spec_kw(model, "port", 2))
    assert eng._spec_cap == win
    prompt = parity.make_prompts(model["jcfg"], (win - 10,), seed=2)[0]
    with pytest.raises(ValueError, match="speculative ring cap"):
        eng.submit(prompt, 20)
    off = PEngine(pp, pcfg, device="cpu")
    with pytest.raises(ValueError, match="window"):
        off.generate(prompt[None], win,
                     draft=PD.DenseDraft(model["pdp"], model["pdcfg"],
                                         device="cpu"),
                     num_draft_tokens=2)


def test_offload_bench_speculative_scenario(monkeypatch, tmp_path):
    """The port's ``offload_bench --speculative`` at its smoke size on the
    CPU, ``tiny-moe`` cut to 2 layers: tokens equal to the baseline's
    (asserted inside), acceptance 1.0, no more h2d bytes than the
    baseline, the reference's row names."""
    from repro_torch.benchmarks import common
    monkeypatch.setattr(common, "BENCH_OUT", tmp_path)
    monkeypatch.setattr(offload_bench, "get_config",
                        lambda name: pget(name).replace(n_layers=2))
    rows = offload_bench.run(smoke=True, speculative=True, device="cpu")
    by = {r["variant"]: r for r in rows}
    assert {"spec_baseline", "speculative", "spec_summary"} <= set(by)
    s = by["spec_summary"]
    assert s["acceptance_rate"] == 1.0 and s["num_draft_tokens"] == 4
    assert s["device_name"] == "cpu" and s["rounds"] > 0
    assert (by["speculative"]["bytes_per_token"]
            <= by["spec_baseline"]["bytes_per_token"])
    assert (tmp_path / "offload_bench.json").exists()
