"""The rest of continuous serving in the port against the JAX reference,
on ``tiny-moe`` cut to 2 layers, on the CPU, with the same seeded weights
crossed over by ``repro_torch.bridge``.

* ``ContinuousEngine`` on the plain plane (dense resident weights) on the
  ``dense``, ``dense_chunked``, ``paged``, ``paged_exact`` and
  ``paged_chunked`` overlays of ``tests/parity.py``: every request's
  tokens and the engine step of each token equal to the reference's, and
  each request's tokens equal to the port's ``generate_plain``.
* The packed engine on dense slot KV (``dense``, ``dense_chunked``):
  tokens, emit steps and ``offload_*`` counters equal to the reference's,
  and equal to the same engine's paged run.
* Expert-overlap admission on the plain plane: the same requests
  admitted into the same slots in the same order.
* ``ServeEngine.serve_batch``: tokens equal to the reference's on mixed
  lengths; a short prompt's tokens do not depend on its neighbours' pads.
* ``forward_train(want_state=True)`` at window 8 with prompts longer
  than the window and left pads: ring positions equal to the reference's
  ``prefill`` state, K/V within 1e-5 (f32, the same products in another
  order); ``pos`` per row equal.
* ``decode_step(row=)`` and ``decode_step(active=)`` on paged states:
  logits within 1e-4 (f32 through the gather MoE, as in
  ``test_torch_plain.py``), every layer's ``ppos`` equal.
* ``KVSlotManager``: allocation order, ``remaining``, ``metrics()``,
  installed rows and ``check_invariants`` equal to the reference's.
* The port's ``serve_bench`` at a cut size: its scenarios' asserts hold
  and its rows carry the reference's keys; the unported scenarios raise
  naming their ROADMAP item.
* Fault F3: the rotary frequencies are made by kernels on the device,
  with no tensor copied from host data (such a copy synchronises the
  stream, twice per attention layer per step), and equal the
  reference's within 1 ulp of float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.serve_bench as JSB
import parity
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import kv_manager as JKV
from repro.serving.engine import ContinuousEngine as JContinuous
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServe
from repro.serving.scheduler import ExpertOverlapPolicy as JOverlap
from repro_torch import bridge
from repro_torch.benchmarks import serve_bench
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.core.offload_engine import generate_plain
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.serving import kv_manager as PKV
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.engine import Request as PRequest
from repro_torch.serving.engine import ServeEngine as PServe
from repro_torch.serving.scheduler import ExpertOverlapPolicy as POverlap

LENS = (5, 9, 5, 9)
MAX_NEWS = (6, 4, 5, 3)
KV_ATOL = 1e-5      # f32 K/V of the same projections, summed in another order
LOGIT_ATOL = 1e-4   # f32 logits through the gather MoE (test_torch_plain.py)
OFFLOAD_KEYS = ("offload_hits", "offload_spec_hits", "offload_demand_loads",
                "offload_spec_loads", "offload_bytes_h2d",
                "offload_bytes_per_token")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    return jcfg, pcfg, params, pparams


def store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.fixture(scope="module")
def packed(model):
    jcfg, pcfg, params, _ = model
    jspec = JSpec(cache_size=2, num_speculative=2, lookahead=1,
                  expert_bits=3, attn_bits=4)
    jeng = JEngine(params, jcfg, jspec, quantized=True)
    pspec = PSpec(**dataclasses.asdict(jspec))
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    peng = PEngine(pp, pcfg, pspec, quantized=True, store=store, device="cpu")
    return jeng, peng


def drive(eng, prompts, max_news):
    """Submit, drain; per request (tokens, emit steps), and the slot each
    request was admitted into, in admission order."""
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


VARIANTS = ["dense", "dense_chunked", "paged", "paged_exact", "paged_chunked"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_continuous_matches_reference(model, variant):
    jcfg, pcfg, params, pp = model
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant], max_slots=2,
              slot_len=64, eos_id=None)
    prompts = parity.make_prompts(jcfg, LENS)
    jres, jadm = drive(JContinuous(params, jcfg, **kw), prompts, MAX_NEWS)
    pce = PContinuous(pp, pcfg, device="cpu", **kw)
    pres, padm = drive(pce, prompts, MAX_NEWS)
    assert [t for t, _ in pres] == [t for t, _ in jres], variant
    assert [s for _, s in pres] == [s for _, s in jres], "emit steps differ"
    assert padm == jadm
    for (toks, _), p, m in zip(pres, prompts, MAX_NEWS):
        assert toks == generate_plain(pp, pcfg, p[None], m,
                                      device="cpu")[0].tolist()
    pce.kv.check_invariants()
    assert pce.kv.n_free == 2 and pce._pstate is None
    assert not any(k.startswith("offload_") for k in pce.stats())


@pytest.mark.parametrize("variant", ["dense", "dense_chunked"])
def test_packed_dense_slots_match_reference(model, packed, variant):
    jcfg, pcfg, _, _ = model
    jeng, peng = packed
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant], max_slots=2,
              slot_len=64, eos_id=None)
    prompts = parity.make_prompts(jcfg, LENS)
    jce = JContinuous(None, jcfg, offload=jeng, **kw)
    pce = PContinuous(None, pcfg, offload=peng, **kw)
    jres, jadm = drive(jce, prompts, MAX_NEWS)
    pres, padm = drive(pce, prompts, MAX_NEWS)
    assert pres == jres and padm == jadm, variant
    js, ps = jce.stats(), pce.stats()
    assert {k: ps[k] for k in OFFLOAD_KEYS} == {k: js[k] for k in OFFLOAD_KEYS}
    assert ps["kv_layout"] == "dense"
    st = pce._pstate
    assert st.h2d_bytes == (st.counts[2] + st.counts[3]) * peng.expert_bytes
    assert EP.pool_coherent(peng.store, st)
    paged = PContinuous(None, pcfg, offload=peng, **dict(kw, kv_page=16))
    assert drive(paged, prompts, MAX_NEWS)[0] == pres
    qs = paged.stats()
    assert {k: qs[k] for k in OFFLOAD_KEYS} == {k: ps[k] for k in OFFLOAD_KEYS}


def test_plain_overlap_admission_matches_reference(model):
    """Admission by expert overlap on the plain plane (the engine reads
    the routing each step for the usage histogram): the same requests
    admitted into the same slots in the same order, the same tokens."""
    jcfg, pcfg, params, pp = model
    prompts = parity.make_prompts(jcfg, (5, 9, 9, 5, 9), seed=4)
    news = (3, 5, 2, 4, 3)
    kw = dict(max_slots=2, slot_len=64, eos_id=None)
    jce = JContinuous(params, jcfg, policy=JOverlap(params, jcfg), **kw)
    pce = PContinuous(pp, pcfg, policy=POverlap(pp, pcfg), device="cpu", **kw)
    jres, jadm = drive(jce, prompts, news)
    pres, padm = drive(pce, prompts, news)
    assert padm == jadm and pres == jres
    np.testing.assert_allclose(pce.usage.counts, jce.usage.counts,
                               rtol=0, atol=1e-12)


def test_serve_batch_matches_reference(model):
    """Mixed lengths and budgets, one row stopping early: the same tokens
    as the reference's static engine (the same dispatch program)."""
    jcfg, pcfg, params, pp = model
    prompts = parity.make_prompts(jcfg, (5, 12, 8, 3), seed=2)
    news = (6, 3, 8, 5)
    want = JServe(params, jcfg).serve_batch(
        [JRequest(p, m) for p, m in zip(prompts, news)])
    got = PServe(pp, pcfg, device="cpu").serve_batch(
        [PRequest(p, m) for p, m in zip(prompts, news)])
    assert [r.completed for r in got] == [r.completed for r in want]
    assert [len(r.completed) for r in got] == list(news)


def test_serve_batch_pad_mask_isolation(model):
    """A short prompt's tokens must not change when a longer neighbour
    forces more padding (the reference's test, on the port)."""
    jcfg, pcfg, _, pp = model
    rng = np.random.default_rng(5)
    short, long1, long2 = (rng.integers(1, pcfg.vocab_size, n).astype(np.int32)
                           for n in (5, 18, 21))
    eng = PServe(pp, pcfg, device="cpu")
    a = eng.serve_batch([PRequest(short, 8), PRequest(long1, 8)])
    b = eng.serve_batch([PRequest(short, 8), PRequest(long2, 8)])
    assert a[0].completed == b[0].completed


def _ref_layer(state, l, name):
    """Layer ``l``'s leaf of the reference's period-stacked state (tiny-moe
    has one pattern position)."""
    return np.asarray(state["stack"][0]["kv"][name][l])


@pytest.mark.parametrize("padded", [False, True], ids=["equal", "left-padded"])
def test_prefill_state_matches_reference(model, padded):
    """Window 8, prompts of 13 and 6 tokens (longer and shorter than the
    window), ring of 24: the state ``forward_train(want_state=True)``
    leaves equals the reference's ``prefill``."""
    jcfg, pcfg, params, pp = model
    jcfg, pcfg = (c.replace(sliding_window=8) for c in (jcfg, pcfg))
    prompts = parity.make_prompts(jcfg, (13, 6) if padded else (13, 13),
                                  seed=9)
    S = 13
    toks = np.zeros((2, S), np.int32)
    mask = np.zeros((2, S), bool)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):], mask[i, S - len(p):] = p, True
    jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if padded:
        jb["pad_mask"], pb["pad_mask"] = jnp.asarray(mask), mask
    jlog, jst = JT.prefill(params, jcfg, jb, 24)
    plog, pst = PT.prefill(pp, pcfg, pb, 24)
    np.testing.assert_array_equal(np.reshape(pst["pos"], -1),
                                  np.broadcast_to(np.asarray(jst["pos"]), (2,))
                                  if padded else np.asarray(jst["pos"]).ravel())
    assert isinstance(pst["pos"], np.ndarray) == padded
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_ATOL)
    for l, blk in enumerate(pst["layers"]):
        np.testing.assert_array_equal(blk["kv"]["pos"].numpy(),
                                      _ref_layer(jst, l, "pos"))
        live = blk["kv"]["pos"].numpy() >= 0
        for name in ("k", "v"):
            np.testing.assert_allclose(blk["kv"][name].numpy()[live],
                                       _ref_layer(jst, l, name)[live],
                                       rtol=0, atol=KV_ATOL)


def test_paged_decode_step_matches_reference(model):
    """Row chunks (``row=``) admit three rows into shared page pools, then
    decode steps with ``active`` masks freeze some rows: every step's
    logits of the live rows within ``LOGIT_ATOL``, ``pos`` and every
    layer's ``ppos`` equal."""
    jcfg, pcfg, params, pp = model
    B, P, ps, T = 3, 12, 4, 5
    jst = JT.init_decode_state(jcfg, B, T * ps, kv_pages=P, kv_page=ps,
                               kv_max_pages=T)
    pst = PT.init_decode_state(pcfg, B, T * ps, "cpu", kv_pages=P,
                               kv_page=ps, kv_max_pages=T)
    pages = np.full((B, T), -1, np.int32)
    pages[0, :3], pages[1, :2], pages[2, :4] = [3, 7, 0], [5, 1], [2, 9, 4, 11]
    jst = dict(jst, pages=jnp.asarray(pages), pos=jnp.zeros(B, jnp.int32))
    pst = dict(pst, pages=pages, pos=np.zeros(B, np.int32))
    rng = np.random.default_rng(3)

    def check(jlog, plog, rows):
        np.testing.assert_allclose(plog.numpy()[rows], np.asarray(jlog)[rows],
                                   rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_array_equal(pst["pos"], np.asarray(jst["pos"]))
        for l, blk in enumerate(pst["layers"]):
            np.testing.assert_array_equal(blk["kv"]["ppos"].numpy(),
                                          _ref_layer(jst, l, "ppos"))

    for slot, n in ((0, 7), (1, 5), (2, 3)):
        tok = rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
        jlog, jst = JT.decode_step(params, jcfg, jst, jnp.asarray(tok),
                                   moe_mode="gather", row=slot)
        plog, pst = PT.decode_step(pp, pcfg, pst, torch.from_numpy(tok),
                                   row=slot)
        check(jlog, plog, slice(None))
    for active in ([True, True, True], [True, False, True],
                   [False, True, False], [True, True, False]):
        act = np.asarray(active)
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jst = JT.decode_step(params, jcfg, jst, jnp.asarray(tok),
                                   moe_mode="gather", active=jnp.asarray(act))
        plog, pst = PT.decode_step(pp, pcfg, pst, torch.from_numpy(tok),
                                   active=act)
        check(jlog, plog, act)


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_manager_matches_reference(model, seed):
    """A seeded run of allocations, installs of prefilled rows (random
    ring contents, positions up to the slot width) and releases: the
    same slots, ``remaining``, metrics, installed rows and audit."""
    jcfg, pcfg, _, _ = model
    jm = JKV.KVSlotManager(jcfg, 3, 16)
    pm = PKV.KVSlotManager(pcfg, 3, 16, device="cpu")
    rng = np.random.default_rng(seed)
    live = []
    for i in range(30):
        if rng.random() < 0.5 and pm.n_free:
            s = pm.allocate(i)
            assert s == jm.allocate(i) and pm.owner(s) == jm.owner(s) == i
            live.append(s)
            jsmall, psmall = jm.new_row_state(), pm.new_row_state()
            n = int(rng.integers(1, 17))
            jsmall["pos"], psmall["pos"] = jnp.int32(n), n
            for l, blk in enumerate(psmall["layers"]):
                for name in ("k", "v"):
                    val = rng.standard_normal(blk["kv"][name].shape[1:])
                    blk["kv"][name][0] = torch.from_numpy(val)
                    leaf = jsmall["stack"][0]["kv"][name]
                    jsmall["stack"][0]["kv"][name] = leaf.at[l, 0].set(val)
            pm.write_prefill(psmall, s)
            jm.write_prefill(jsmall, s)
        elif live:
            s = live.pop(int(rng.integers(len(live))))
            pm.release(s)
            jm.release(s)
        assert [pm.remaining(s) for s in live] == [jm.remaining(s) for s in live]
        assert pm.metrics() == jm.metrics() and pm.stats() == jm.stats()
        for l, blk in enumerate(pm.state["layers"]):
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    blk["kv"][name].numpy()[live],
                    _ref_layer(jm.state, l, name)[live].astype(np.float32))
        pm.check_invariants()
        jm.check_invariants()
    wide = PT.init_decode_state(pcfg, 1, 32, "cpu")
    with pytest.raises(ValueError, match="width"):
        pm.write_prefill(wide, 0)
    for call, item in ((lambda: pm.snapshot(0), "item 6"),
                       (lambda: pm.restore(None, 0), "item 6"),
                       (lambda: pm.truncate(0, 1), "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_unbounded_swa_slots_decode_past_slot_len(model):
    """An all-SWA stack whose dense slots hold the window rolls inside its
    ring: a request may need more positions than ``slot_len`` (the
    reference's rule), and it still decodes what ``generate_plain``
    decodes; pages never roll, so there it is refused."""
    jcfg, pcfg, params, pp = model
    jcfg, pcfg = (c.replace(sliding_window=8) for c in (jcfg, pcfg))
    prompt = parity.make_prompts(jcfg, (6,), seed=7)[0]
    kw = dict(max_slots=2, slot_len=8, eos_id=None)
    jce = JContinuous(params, jcfg, **kw)
    pce = PContinuous(pp, pcfg, device="cpu", **kw)
    want = drive(jce, [prompt], [10])[0]
    assert drive(pce, [prompt], [10])[0] == want
    assert want[0][0] == generate_plain(pp, pcfg, prompt[None], 10,
                                        device="cpu")[0].tolist()
    with pytest.raises(ValueError, match="slot_len"):
        PContinuous(pp, pcfg, device="cpu", kv_page=4, **kw).submit(prompt, 10)


def test_serve_bench_scenarios_run(model, monkeypatch, tmp_path):
    """The port's serve_bench at its quick sizes on ``tiny-moe`` cut to 2
    layers, on the CPU: every scenario's own asserts hold (token parity,
    equal packed counters, fewer peak KV positions on pages, token counts
    within 25 %), the rows carry the reference's keys plus the device,
    and they land in the port's bench directory."""
    jcfg, pcfg, _, _ = model
    for fn, args in (("make_workload", (6,)), ("make_latency_workload", (2,))):
        got = getattr(serve_bench, fn)(pcfg, *args, smoke=True)
        want = getattr(JSB, fn)(jcfg, *args, smoke=True)
        assert [(p.tolist(), m) for p, m in got] == \
            [(p.tolist(), m) for p, m in want]
    monkeypatch.setattr(serve_bench, "get_config",
                        lambda name: pget(name).replace(n_layers=2))
    monkeypatch.setattr(serve_bench.common, "BENCH_OUT", tmp_path)
    rows = serve_bench.run(quick=True, device="cpu")
    assert [r["scenario"] for r in rows] == [
        "continuous_vs_static", "chunked_prefill", "chunked_prefill_packed",
        "paged_kv"]
    assert all(r["device"] == "cpu" for r in rows)
    assert rows[2]["counters_identical"] and rows[3]["token_parity"]
    assert rows[3]["paged_peak_kv_positions"] < rows[3]["dense_peak_kv_positions"]
    assert (tmp_path / "serve_bench.json").exists()


@pytest.mark.parametrize("scenario,item", [
    ("run_telemetry_overhead", "item 7"), ("run_prefix_reuse", "item 5"),
    ("run_overload_preempt", "item 5"), ("run_chaos", "item 5"),
    ("run_zoo", "item 6")])
def test_unported_scenarios_raise(scenario, item):
    with pytest.raises(NotImplementedError, match=item):
        getattr(serve_bench, scenario)(None, None)


@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-offload"])
def test_rope_frequencies_copy_nothing_from_the_host(name, monkeypatch):
    cfg = pget(name)
    want, want_rot = JL.rope_frequencies(jget(name))

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host data")

    for fn in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, refuse)
    got, rot = PL.rope_frequencies(cfg, torch.device("cpu"))
    monkeypatch.undo()
    assert rot == want_rot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -23,
                               atol=0)
