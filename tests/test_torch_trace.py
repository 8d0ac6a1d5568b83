"""The port's trace tools against the JAX reference's, on the CPU:
``collect_trace`` over the plain plane on ``tiny-moe`` (4 layers, seeded
weights crossed over by ``repro_torch.bridge``), the trace replays of the
paper's Fig. 2 (``lru_hit_curve``, ``policy_comparison``,
``belady_hit_ratio``, ``PyLFUDecay``, ``recall_curve``) on that trace, and
the HQQ tree helpers.  Ids, hit ratios and byte counts exact; hidden
states and probabilities within 1e-5 (float32, other summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lru_cache as JLC
from repro.core import speculative as JSP
from repro.core import trace as JTR
from repro.models import transformer as JT
from repro.quant import hqq as JQ
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.core import lru_cache as PLC
from repro_torch.core import speculative as PSP
from repro_torch.core import trace as PTR
from repro_torch.quant import hqq as PQ

TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = [1, 2, 3, 4, 6]


@pytest.fixture(scope="module")
def traces():
    jcfg = jget("tiny-moe").replace(n_layers=4)
    pcfg = pget("tiny-moe").replace(n_layers=4)
    params = JT.init_model(jax.random.key(11), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (1, 40)).astype(np.int32)
    return JTR.collect_trace(params, jcfg, tokens), \
        PTR.collect_trace(pp, pcfg, tokens, device="cpu")


def test_collect_trace_matches(traces):
    j, p = traces
    assert p["ids"].shape == (40, 4, 2) and p["ids"].dtype == np.int32
    np.testing.assert_array_equal(p["ids"], j["ids"])
    np.testing.assert_allclose(p["hiddens"], j["hiddens"], **TOL)
    np.testing.assert_allclose(p["probs"], j["probs"], **TOL)
    np.testing.assert_array_equal(p["routers"], j["routers"])


def test_lru_hit_curve_matches(traces):
    j, p = traces
    got = PLC.lru_hit_curve(p["ids"], SIZES)
    assert got == JLC.lru_hit_curve(j["ids"], SIZES)
    assert 0 < got[2] < got[6] <= 1


def test_policy_comparison_matches(traces):
    j, p = traces
    assert PLC.policy_comparison(p["ids"], SIZES) == \
        JLC.policy_comparison(j["ids"], SIZES)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_belady_and_lfu_decay_match(traces, k):
    """Per layer: Belady's hit ratio and the decayed-LFU cache's counters
    equal the reference's; Belady bounds LRU."""
    j, p = traces
    for l in range(p["ids"].shape[1]):
        b = PLC.belady_hit_ratio(p["ids"][:, l], k)
        assert b == JLC.belady_hit_ratio(j["ids"][:, l], k)
        pl, jl, lru = PLC.PyLFUDecay(k), JLC.PyLFUDecay(k), PLC.PyLRU(k, 0)
        for t in range(p["ids"].shape[0]):
            pl.access(p["ids"][t, l])
            jl.access([int(e) for e in j["ids"][t, l]])
            lru.access(p["ids"][t, l])
        assert (pl.hits, pl.demand, pl.cache) == (jl.hits, jl.demand, jl.cache)
        assert b >= lru.hits / p["ids"][:, l].size


def test_recall_curve_matches(traces):
    j, p = traces
    args = dict(lookaheads=[1, 2], n_fetch_list=[1, 2, 4])
    got = PSP.recall_curve(p["hiddens"], p["routers"], p["ids"], **args)
    want = JSP.recall_curve(j["hiddens"], j["routers"], j["ids"], **args)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert got[(1, 4)] >= got[(1, 1)]


def _tree():
    rng = np.random.default_rng(9)
    a = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {"w": a(128, 64), "stack": [a(2, 256, 32), a(64, 48)],
            "bias": a(64), "odd": a(40, 16)}


def test_tree_helpers_match():
    """``quantize_tree`` quantizes the same leaves as the reference (>= 2-D,
    K divisible by the group size); ``tree_nbytes``, ``dense_nbytes``,
    ``dequantize_tree`` of the reference's own quantized tree and
    ``quant_error`` agree."""
    tree = _tree()
    jt = jax.tree.map(jnp.asarray, tree)
    pt = PQ.tree_map(torch.from_numpy, tree)
    jq, pq = JQ.quantize_tree(jt, 4), PQ.quantize_tree(pt, 4)
    is_q = lambda t, cls: {k: isinstance(v, cls) for k, v in
                           [("w", t["w"]), ("s0", t["stack"][0]),
                            ("s1", t["stack"][1]), ("b", t["bias"]),
                            ("o", t["odd"])]}
    assert is_q(pq, PQ.QTensor) == is_q(jq, JQ.QTensor) == {
        "w": True, "s0": True, "s1": True, "b": False, "o": False}
    assert PQ.tree_nbytes(pq) == JQ.tree_nbytes(jq)
    assert PQ.dense_nbytes(pt) == JQ.dense_nbytes(jt)
    assert PQ.dense_nbytes(pq) == JQ.dense_nbytes(jq)

    def to_port(t):
        if isinstance(t, JQ.QTensor):
            c = lambda x: torch.from_numpy(np.array(x))
            return PQ.QTensor(c(t.packed), c(t.scale), c(t.zero),
                              {k: c(v) for k, v in t.meta.items()},
                              t.bits, t.group_size, tuple(t.shape))
        return torch.from_numpy(np.array(t))

    jd = JQ.dequantize_tree(jq)
    pd = PQ.dequantize_tree({"w": to_port(jq["w"]),
                             "stack": [to_port(q) for q in jq["stack"]],
                             "bias": to_port(jq["bias"]),
                             "odd": to_port(jq["odd"])})
    np.testing.assert_array_equal(pd["w"].numpy(), np.asarray(jd["w"]))
    np.testing.assert_array_equal(pd["stack"][0].numpy(),
                                  np.asarray(jd["stack"][0]))
    for name in ("w",):
        je = JQ.quant_error(jt[name], jq[name])
        pe = PQ.quant_error(pt[name], to_port(jq[name]))
        assert pe["bits_per_param"] == je["bits_per_param"] == \
            PQ.bits_per_param(pq[name])
        assert pe["max_abs"] == pytest.approx(je["max_abs"], rel=1e-6)
        assert pe["rel_fro"] == pytest.approx(je["rel_fro"], rel=1e-5)
