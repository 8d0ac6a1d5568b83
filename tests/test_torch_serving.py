"""The port's serving managers against the JAX reference's, on the CPU:
page allocation and scrubbing, step plans, the scheduler's admission
decisions under FCFS and expert overlap, expert-usage accounting and the
sampler.  Integer state is compared exactly: tables, free lists, stats,
plans, picks, kept-token masks and greedy tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import offload_engine as JOE
from repro.models import transformer as JT
from repro.runtime import plan as JPlan
from repro.serving import kv_manager as JKV
from repro.serving import sampler as JS
from repro.serving import scheduler as JSch
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.core import offload_engine as POE
from repro_torch.runtime import plan as PPlan
from repro_torch.serving import kv_manager as PKV
from repro_torch.serving import sampler as PS
from repro_torch.serving import scheduler as PSch


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(2), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    return jcfg, pcfg, params, pparams


def _ref_ppos(state):
    """The reference's (n_periods, P, ps) ppos of the one pattern position."""
    return np.asarray(state["stack"][0]["kv"]["ppos"])


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_manager_matches_reference(model, seed):
    """A seeded sequence of admissions, page growth and releases, with
    positions written into every owned page: the same slots, tables, free
    lists, stats and live widths, and released pages scrubbed to -1 in
    every layer, exactly as the reference scrubs them."""
    jcfg, pcfg, _, _ = model
    args = (3, 4, 14, 5)  # slots, page size, pages, pages per slot
    jm = JKV.PagedKVManager(jcfg, *args)
    pm = PKV.PagedKVManager(pcfg, *args, device="cpu")
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(60):
        op = rng.random()
        if op < 0.35 and pm.n_free:
            n = int(rng.integers(1, 21))
            assert pm.can_admit(n) == jm.can_admit(n)
            if pm.can_admit(n):
                s = pm.allocate(len(live), n)
                assert s == jm.allocate(len(live), n)
                live.append((s, n))
        elif op < 0.75 and live:
            s, n = live[int(rng.integers(len(live)))]
            grow = int(rng.integers(pm.length(s), n + 1))
            pm.ensure(s, grow)
            jm.ensure(s, grow)
            pm.note_tokens(s, grow)
            jm.note_tokens(s, grow)
            for pid in pm.pool.owned[s]:  # the row's positions land in its pages
                val = np.arange(4, dtype=np.int32) + 4 * pid
                for blk in pm.state["layers"]:
                    blk["kv"]["ppos"][pid] = torch.from_numpy(val)
                jm.state["stack"][0]["kv"]["ppos"] = jm.state["stack"][0][
                    "kv"]["ppos"].at[:, pid].set(val)
        elif live:
            s, _ = live.pop(int(rng.integers(len(live))))
            pm.release(s)
            jm.release(s)
        np.testing.assert_array_equal(pm.state["pages"], jm._pages_np)
        assert sorted(pm.pool._free) == sorted(jm.pool._free)
        assert pm.pool.owned == jm.pool.owned
        assert pm.pool.reserved == jm.pool.reserved
        assert pm.pool.stats() == jm.pool.stats()
        assert [(pm.length(s), pm.remaining(s)) for s in range(3)] == \
            [(jm.length(s), jm.remaining(s)) for s in range(3)]
        busy = [s for s, _ in live]
        assert pm.live_width(busy) == jm.live_width(busy)
        ppos = np.stack([b["kv"]["ppos"].numpy() for b in pm.state["layers"]])
        np.testing.assert_array_equal(ppos, _ref_ppos(jm.state))
        pm.check_invariants()
    pmet, jmet = pm.metrics(), jm.metrics()
    assert {k: pmet[k] for k in pmet} == {k: jmet[k] for k in pmet}


def test_state_manager_matches_reference(model):
    """The paged and the dense family, each built as the reference's
    manager builds it; a page budget without a page size is refused by
    both."""
    jcfg, pcfg, _, _ = model
    m = PKV.StateManager.create(pcfg, 2, 50, kv_page=16, device="cpu")
    j = JKV.StateManager.create(jcfg, 2, 50, kv_page=16)
    assert (m.slot_len, m.pool.n_pages, m.max_pages) == \
        (j.slot_len, j.pool.n_pages, j.max_pages)
    assert m.metrics() == j.metrics()
    m = PKV.StateManager.create(pcfg, 2, 50, device="cpu")
    j = JKV.StateManager.create(jcfg, 2, 50)
    assert type(m).__name__ == type(j).__name__ == "KVSlotManager"
    assert m.slot_len == j.slot_len and m.metrics() == j.metrics()
    assert m.state["layers"][0]["kv"]["k"].shape == \
        np.asarray(j.state["stack"][0]["kv"]["k"]).shape[1:]
    for mgr, cfg in ((PKV.StateManager, pcfg), (JKV.StateManager, jcfg)):
        with pytest.raises(ValueError, match="kv_page"):
            mgr.create(cfg, 2, 50, kv_pages_total=8)


@pytest.mark.parametrize("seed", range(3))
def test_token_budget_plans_match(seed):
    rng = np.random.default_rng(seed)
    jp = JPlan.TokenBudgetPolicy(chunk_size=4, token_budget=9, max_rows=3)
    pp = PPlan.TokenBudgetPolicy(chunk_size=4, token_budget=9, max_rows=3)
    for _ in range(20):
        rows = sorted(rng.choice(3, int(rng.integers(0, 4)), replace=False))
        adm = [(int(rng.integers(1, 15)), int(rng.integers(0, 5)))
               for _ in range(int(rng.integers(0, 3)))]
        want = jp.plan(rows, [JPlan.Admission(i, i, t, next_lo=min(lo, t))
                              for i, (t, lo) in enumerate(adm)])
        got = pp.plan(rows, [PPlan.Admission(i, i, t, next_lo=min(lo, t))
                             for i, (t, lo) in enumerate(adm)])
        assert got.decode_rows == want.decode_rows
        assert [vars(c) for c in got.chunks] == [vars(c) for c in want.chunks]
        assert got.total_tokens == want.total_tokens


def test_admission_cost_matches(model):
    jcfg, pcfg, _, _ = model
    for S, n in ((5, 3), (300, 40)):
        assert vars(PSch.admission_cost(pcfg, S, n)) == \
            vars(JSch.admission_cost(jcfg, S, n))


@pytest.mark.parametrize("overlap", [False, True], ids=["fcfs", "overlap"])
def test_scheduler_decisions_match(model, overlap):
    """The same queue, the same usage history: the same pick at every
    admission, the same lifecycle counts."""
    jcfg, pcfg, params, pparams = model
    rng = np.random.default_rng(int(overlap))
    jsch = JSch.Scheduler(2, JSch.ExpertOverlapPolicy(params, jcfg)
                          if overlap else None, queue_cap=6)
    psch = PSch.Scheduler(2, PSch.ExpertOverlapPolicy(pparams, pcfg)
                          if overlap else None, queue_cap=6)
    ju = JOE.ExpertUsageTracker.for_config(jcfg)
    pu = POE.ExpertUsageTracker.for_config(pcfg)
    live = []
    for i in range(40):
        if rng.random() < 0.5:
            prompt = rng.integers(1, 500, int(rng.integers(1, 6)), np.int32)
            ok = jsch.submit(JSch.GenRequest(prompt, rid=i))
            assert psch.submit(PSch.GenRequest(prompt, rid=i)) == ok
        ids = [rng.integers(0, 8, (2, 2)).astype(np.int32) for _ in range(2)]
        rows = sorted(rng.choice(2, int(rng.integers(1, 3)), replace=False))
        ju.update(ids, rows=rows)
        pu.update(ids, rows=rows)
        np.testing.assert_allclose(pu.counts, ju.counts, rtol=0, atol=0)
        if jsch.waiting and len(jsch.running) < 2:
            (ji, jr), (pi, pr) = jsch.peek_next(ju), psch.peek_next(pu)
            assert pi == ji and pr.rid == jr.rid
            for sch, k in ((jsch, ji), (psch, pi)):
                req = sch.pop_at(k)
                req.slot = len(live) % 2
            live.append(jr.rid)
        if live and rng.random() < 0.3:
            rid = live.pop(0)
            for sch in (jsch, psch):
                req = next(r for r in sch.running if r.rid == rid)
                sch.evict(req, "length")
        assert psch.metrics() == jsch.metrics()
    assert psch.joins > 3


def test_routing_from_info_matches(model):
    """Per-layer routing from the port's per-layer infos equals the
    reference's unpacking of its scan-stacked info."""
    jcfg, pcfg, _, _ = model
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 8, (2, 3, 2)).astype(np.int32)   # (period, B, K)
    hid = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    jstack = [{"route": {"ids": ids}, "hidden_pre_moe": hid}]
    pinfos = [{"route": {"ids": ids[l]},
               "hidden_pre_moe": torch.from_numpy(hid[l])} for l in range(2)]
    for want_h in (True, False):
        (ji, jh), (pi, ph) = (JOE.routing_from_info(jcfg, jstack, want_h),
                              POE.routing_from_info(pcfg, pinfos, want_h))
        for a, b in zip(pi + ph, ji + jh):
            np.testing.assert_array_equal(a, b)
        assert len(pi) == len(ji) and len(ph) == len(jh)


def test_sampler_matches():
    """Greedy tokens exactly; the top-p and top-k filters keep exactly the
    reference's tokens; the stochastic draws come from the generator and
    stay inside the kept set."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 300)).astype(np.float32) * 3
    key = jax.random.key(0)
    gen = torch.Generator().manual_seed(0)
    greedy = JS.SamplerConfig(kind="greedy")
    np.testing.assert_array_equal(
        PS.sample(gen, torch.from_numpy(logits), PS.SamplerConfig("greedy")),
        np.asarray(JS.sample(key, jnp.asarray(logits), greedy)))
    for p in (0.5, 0.9):
        keep = PS._top_p_filter(torch.from_numpy(logits), p).numpy() > -1e29
        want = np.asarray(JS._top_p_filter(jnp.asarray(logits), p)) > -1e29
        np.testing.assert_array_equal(keep, want)
        cfg = PS.SamplerConfig(kind="topp", top_p=p, temperature=1.0)
        for _ in range(5):
            tok = PS.sample(gen, torch.from_numpy(logits), cfg).numpy()
            assert keep[np.arange(4), tok].all()
    cfg = PS.SamplerConfig(kind="topk", top_k=5)
    top5 = np.argsort(-logits, -1)[:, :5]
    tok = PS.sample(gen, torch.from_numpy(logits), cfg,
                    temperature=[0.5, 1.0, 2.0, 1.0]).numpy()
    assert all(t in row for t, row in zip(tok, top5))
