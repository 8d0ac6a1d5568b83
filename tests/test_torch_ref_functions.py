"""The reference's last public functions, held to it on the CPU:
``moe.packed_expert_ffn`` with ``moe_apply_dispatch(expert_ffn_fn=)``
(the scatter-dispatch MoE straight from the packed host store, one
expert at a time), ``lru_cache.access`` / ``stage_speculative`` /
``layer_slice`` / ``set_layer`` on the reference's ``tests/test_lru.py``
sequences, and ``transformer.layer_kind``.

The packed store is the reference's (``expert_pool.build_store``),
crossed into the port byte for byte through ``repro_torch.bridge``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core import expert_pool as JEP
from repro.core import lru_cache as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core import lru_cache as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.quant import hqq

from test_torch_sharding import ARCHS

# the packed dispatch against the reference's, float32 (XLA and torch
# sum the products in their own orders; measured 3.4e-7)
REF_ATOL = 1e-5


def _store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.fixture(scope="module", params=["swiglu", "geglu"])
def packed(request):
    """tiny-moe cut to 2 layers (as the reference's ``_packed_moe_setup``
    otherwise: seed 20, 3-bit experts) with its packed store in both
    packages, and 24 rows."""
    jcfg = jget("tiny-moe").replace(mlp_act=request.param, n_layers=2)
    pcfg = pget("tiny-moe").replace(mlp_act=request.param, n_layers=2)
    jparams = JT.init_model(jax.random.key(20), jcfg)
    jspec = JSpec(cache_size=2, num_speculative=2, expert_bits=3,
                  attn_bits=4)
    jstore = JEP.build_store(jparams, jcfg, jspec)
    pspec = PSpec(**dataclasses.asdict(jspec))
    pstore = bridge.store_from_numpy(_store_leaves(jstore), pcfg, pspec,
                                     "cpu")
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       pcfg, "cpu")
    x = np.random.default_rng(22).standard_normal(
        (24, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams, jstore=jstore,
                pstore=pstore, pparams=pparams, x=x)


@pytest.mark.parametrize("l", [0, 1])
def test_packed_dispatch_matches_reference(packed, l):
    """``moe_apply_dispatch(expert_ffn_fn=packed_expert_ffn(store, l))``
    against the reference's on the same packed bytes (within
    ``REF_ATOL``), and equal to the port's own dispatch over the
    dequantized stack (the same products of the same rows: exactly),
    swiglu and geglu."""
    jcfg, pcfg = packed["jcfg"], packed["pcfg"]
    jmoe = JT.layer_params(packed["jparams"], jcfg, l)["moe"]
    y_ref, _ = JM.moe_apply_dispatch(
        jmoe, jcfg, jnp.asarray(packed["x"]),
        expert_ffn_fn=JM.packed_expert_ffn(packed["jstore"], jnp.asarray(l),
                                           jcfg))
    router = packed["pparams"]["layers"][l]["moe"]["router"]
    x = torch.as_tensor(packed["x"])
    with torch.no_grad():
        y, _ = M.moe_apply_dispatch(
            {"router": router}, pcfg, x,
            expert_ffn_fn=M.packed_expert_ffn(packed["pstore"], l, pcfg))
        deq = {m: hqq.dequantize(qt, torch.float32) for m, qt in
               zip(EP.EXPERT_MATS, packed["pstore"].layer(l))}
        y_stack, _ = M.moe_apply_dispatch({"router": router,
                                           "experts": deq}, pcfg, x)
    y_ref = np.asarray(y_ref)
    assert np.abs(y.numpy() - y_ref).max() <= REF_ATOL, \
        np.abs(y.numpy() - y_ref).max()
    assert torch.equal(y, y_stack)
    assert np.abs(y_ref).max() > 0.01  # the experts did contribute


def test_packed_expert_ffn_builds_no_dense_stack(packed, monkeypatch):
    """Each call dequantizes one expert's three matrices (2-D), never an
    (E, ...) stack."""
    shapes = []
    real = hqq.dequantize

    def spy(qt, dtype=torch.float32):
        shapes.append(tuple(qt.shape))
        return real(qt, dtype)
    monkeypatch.setattr(hqq, "dequantize", spy)
    pcfg = packed["pcfg"]
    ffn = M.packed_expert_ffn(packed["pstore"], 1, pcfg)
    E = pcfg.moe.num_experts
    y = ffn(torch.zeros((E, 4, pcfg.d_model)))
    assert y.shape == (E, 4, pcfg.d_model)
    assert len(shapes) == 3 * E and all(len(s) == 2 for s in shapes)


# ----------------------------------------------------------------------
# the LRU state machine: the reference's test_lru.py sequences through
# both packages' access / stage_speculative, states and counts equal
def _same_state(js, ps):
    assert np.asarray(js.cache_ids).tolist() == ps.cache_ids.tolist()
    assert np.asarray(js.cache_clock).tolist() == ps.cache_clock.tolist()
    assert np.asarray(js.spec_ids).tolist() == ps.spec_ids.tolist()
    assert int(js.clock) == ps.clock


class Both:
    """One layer's state in both packages, stepped together."""

    def __init__(self, k, n_spec):
        self.j, self.p = JL.init_layer_state(k, n_spec), \
            L.init_layer_state(k, n_spec)

    def access(self, needed):
        self.j, js = JL.access(self.j, jnp.asarray(needed, jnp.int32))
        self.p, ps = L.access(self.p, list(needed))
        assert tuple(int(v) for v in js) == tuple(ps)
        _same_state(self.j, self.p)
        return ps

    def stage(self, predicted):
        self.j, jn = JL.stage_speculative(self.j,
                                          jnp.asarray(predicted, jnp.int32))
        self.p, pn = L.stage_speculative(self.p, list(predicted))
        assert int(jn) == pn
        _same_state(self.j, self.p)
        return pn


def test_lru_basic_hit_miss():
    s = Both(k=2, n_spec=2)
    assert s.access([3, 5]).demand_loads == 2
    assert s.access([3, 5]).hits == 2
    assert s.access([7, 5]).demand_loads == 1
    assert set(s.p.cache_ids.tolist()) == {5, 7}


def test_lru_speculative_hit_promotes():
    s = Both(k=2, n_spec=2)
    s.access([0, 1])
    assert s.stage([4, 5]) == 2
    st = s.access([4, 1])
    assert (st.spec_hits, st.hits, st.demand_loads) == (1, 1, 0)
    assert 4 in s.p.cache_ids.tolist()


def test_lru_stage_skips_resident():
    s = Both(k=2, n_spec=2)
    s.access([0, 1])
    assert s.stage([0, 3]) == 1


@pytest.mark.parametrize("seed", range(6))
def test_lru_seeded_oracle_sequences(seed):
    """The reference's seeded oracle sequences (its
    ``test_jnp_matches_python_oracle_seeded`` draws): both packages and
    the port's ``PyLRU`` agree on every state and count."""
    rng = np.random.default_rng(1000 + seed)
    k, n_spec = int(rng.integers(1, 7)), int(rng.integers(1, 4))
    n_experts, seed2 = int(rng.integers(2, 13)), int(rng.integers(2**31))
    n_steps = int(rng.integers(8, 41))
    rng = np.random.default_rng(seed2)
    top_k, n_spec = min(2, n_experts), min(n_spec, n_experts)
    s, py = Both(k, n_spec), L.PyLRU(k, n_spec)
    tot = np.zeros(4, np.int64)
    for _ in range(n_steps):
        needed = rng.choice(n_experts, size=top_k, replace=False)
        st = s.access(needed.tolist())
        py.access(needed.tolist())
        tot[:3] += (st.hits, st.spec_hits, st.demand_loads)
        pred = rng.choice(n_experts, size=n_spec, replace=False)
        tot[3] += s.stage(pred.tolist())
        py.stage(pred.tolist())
        assert set(s.p.cache_ids.tolist()) - {-1} == set(py.cache)
    assert tot.tolist() == [py.hits, py.spec_hits, py.demand, py.spec_loads]


def test_layer_slice_and_set_layer_match_reference():
    n_layers, k, n_spec = 4, 3, 2
    jm = JL.init_model_state(n_layers, k, n_spec)
    pm = L.init_model_state(n_layers, k, n_spec)
    for l, needed in ((2, [5, 1]), (0, [3, 4]), (2, [1, 6])):
        jl, _ = JL.access(JL.layer_slice(jm, l), jnp.asarray(needed,
                                                             jnp.int32))
        pl, _ = L.access(L.layer_slice(pm, l), needed)
        before = [L.layer_slice(pm, i) for i in range(n_layers)]
        jm, pm_new = JL.set_layer(jm, l, jl), L.set_layer(pm, l, pl)
        # functional: the old model state is left as it was
        assert all(a is b for a, b in zip(pm, before))
        pm = pm_new
        for i in range(n_layers):
            _same_state(JL.layer_slice(jm, i), L.layer_slice(pm, i))


def test_layer_kind_matches_reference():
    for arch in ARCHS:
        jcfg, pcfg = jget(arch), pget(arch)
        n = pcfg.n_layers + pcfg.pattern_period  # tail and beyond
        assert [T.layer_kind(pcfg, i) for i in range(n)] == \
            [JT.layer_kind(jcfg, i) for i in range(n)], arch
