"""The port's host-side LRU/staging state machine against the JAX
reference's, on seeded random traces: every state array, slot plan,
mask, eviction and counter must be exactly equal (ported from
``tests/test_lru.py::test_jnp_matches_python_oracle``)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import lru_cache as J
from repro_torch.core import lru_cache as P


def assert_state_equal(sp: P.LayerCacheState, sj):
    np.testing.assert_array_equal(sp.cache_ids, np.asarray(sj.cache_ids))
    np.testing.assert_array_equal(sp.cache_clock, np.asarray(sj.cache_clock))
    np.testing.assert_array_equal(sp.spec_ids, np.asarray(sj.spec_ids))
    assert sp.clock == int(sj.clock)


def assert_fields_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def _params(seed):
    rng = np.random.default_rng(2000 + seed)
    n_experts = int(rng.integers(2, 13))
    return dict(k=int(rng.integers(1, 7)),
                n_spec=min(int(rng.integers(1, 4)), n_experts),
                n_experts=n_experts, n_steps=int(rng.integers(8, 31)),
                trace_seed=int(rng.integers(2 ** 31)))


@pytest.mark.parametrize("seed", range(6))
def test_access_and_stage_plans_match_reference(seed):
    p = _params(seed)
    rng = np.random.default_rng(p["trace_seed"])
    top_k = min(2, p["n_experts"])
    sj = J.init_layer_state(p["k"], p["n_spec"])
    sp = P.init_layer_state(p["k"], p["n_spec"])
    pyj, pyp = J.PyLRU(p["k"], p["n_spec"]), P.PyLRU(p["k"], p["n_spec"])
    for _ in range(p["n_steps"]):
        needed = rng.choice(p["n_experts"], size=top_k, replace=False)
        sj, stj, plj = J.access_plan(sj, jnp.asarray(needed, jnp.int32))
        sp, stp, plp = P.access_plan(sp, needed)
        assert_state_equal(sp, sj)
        assert tuple(stp) == tuple(int(v) for v in stj)
        assert_fields_equal(plp, plj, P.AccessPlan._fields)
        pyj.access(needed.tolist())
        pyp.access(needed.tolist())
        pred = rng.choice(p["n_experts"], size=p["n_spec"], replace=False)
        if rng.random() < 0.3:  # repeated predictions exercise the dedupe
            pred[-1] = pred[0]
        sj, splj, nj = J.stage_plan(sj, jnp.asarray(pred, jnp.int32))
        sp, splp, n_p = P.stage_plan(sp, pred)
        assert_state_equal(sp, sj)
        assert n_p == int(nj)
        assert_fields_equal(splp, splj, P.StagePlan._fields)
        pyj.stage(pred.tolist())
        pyp.stage(pred.tolist())
    assert pyp.evictions == pyj.evictions
    assert (pyp.hits, pyp.spec_hits, pyp.demand, pyp.spec_loads) == \
        (pyj.hits, pyj.spec_hits, pyj.demand, pyj.spec_loads)
    assert pyp.cache == pyj.cache and pyp.spec == pyj.spec


@pytest.mark.parametrize("T,active", [(1, None), (3, None),
                                      (3, (True, False, True)),
                                      (4, (False, True, True, False))])
def test_access_plan_batch_matches_reference(T, active):
    rng = np.random.default_rng(17 + T)
    k, K, E = 2, 2, 8
    sj, sp = J.init_layer_state(k, 2), P.init_layer_state(k, 2)
    for _ in range(10):
        ids = rng.integers(0, E, (T, K)).astype(np.int32)
        act = None if active is None else np.asarray(active)
        sj, dj, pj = J.access_plan_batch(
            sj, jnp.asarray(ids), None if act is None else jnp.asarray(act))
        sp, dp, pp = P.access_plan_batch(sp, ids, act)
        assert_state_equal(sp, sj)
        np.testing.assert_array_equal(dp, np.asarray(dj))
        assert_fields_equal(pp, pj, ("slots", "survives", "written"))
        pred = rng.choice(E, size=2, replace=False)
        sj, _, _ = J.stage_plan(sj, jnp.asarray(pred, jnp.int32))
        sp, _, _ = P.stage_plan(sp, pred)


def test_batch_plan_sources_replay_sequential_plans():
    """The per-access byte sources the pool copies from are those of the
    sequential ``access_plan`` calls."""
    rng = np.random.default_rng(5)
    s = P.init_layer_state(3, 2)
    s, _, _ = P.stage_plan(s, [4, 6])
    ids = rng.integers(0, 8, (3, 2)).astype(np.int32)
    _, _, bp = P.access_plan_batch(s, ids)
    for t in range(3):
        s, _, ap = P.access_plan(s, ids[t])
        np.testing.assert_array_equal(bp.in_cache[t], ap.in_cache)
        np.testing.assert_array_equal(bp.in_spec[t], ap.in_spec)
        np.testing.assert_array_equal(bp.spec_slot[t], ap.spec_slot)
