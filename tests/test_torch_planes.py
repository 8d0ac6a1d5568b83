"""The paper's three offload data planes on the port against the JAX
reference, on ``tiny-moe`` cut to 2 layers (3-bit experts), on the CPU:
the ``(pipelined, vectorized, fused)`` combinations of the reference's
``offload_bench``, plus dequantize-and-einsum.

* ``OffloadEngine(..., pipelined=, vectorized=, fused=)`` against the
  reference's decoder with the same flags, over the same bytes (the
  reference quantizes once; its parameters and store cross into the port
  through ``repro_torch.bridge``): equal greedy tokens, routing ids per
  layer and step and ``OffloadStats`` counters; logits within atol 1e-4
  in float32 (the same products summed in another order; the
  dequantize-and-einsum plane sums in another order again); h2d bytes
  issued equal to the counters.
* ``expert_pool``'s unrolled ``acquire``/``stage`` against the vectorized
  ones on random traces: equal counters, LRU state and h2d bytes, every
  served record holding its expert's store bytes, the pool coherent.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.core.offload_engine import PackedDecoder as JDecoder
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine

from test_torch_offload import PROMPT, reference_run, store_leaves

N_NEW = 6
LOGIT_ATOL = 1e-4
# (pipelined, vectorized, fused): offload_bench's pipelined, vectorized and
# pr2_sync variants, and the vectorized plane without the fused kernels
PLANES = [(True, True, True), (False, True, True), (False, False, True),
          (False, True, False)]


@pytest.fixture(scope="module")
def quantized():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    jspec = JSpec(cache_size=2, num_speculative=2, lookahead=1,
                  expert_bits=3, attn_bits=4)
    jeng = JEngine(JT.init_model(jax.random.key(1), jcfg), jcfg, jspec,
                   quantized=True)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    pspec = PSpec(**dataclasses.asdict(jspec))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                      pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    return jeng, jcfg, jspec, params, store, pcfg, pspec


@pytest.mark.parametrize("pipelined,vectorized,fused", PLANES,
                         ids=["pipelined", "vectorized", "pr2_sync",
                              "vectorized-unfused"])
def test_plane_matches_reference(quantized, pipelined, vectorized, fused):
    jeng, jcfg, jspec, params, store, pcfg, pspec = quantized
    flags = dict(pipelined=pipelined, vectorized=vectorized, fused=fused)
    jtoks, jlogits, jroutes, jps = reference_run(
        JDecoder(jeng.params, jcfg, jspec, jeng.store, **flags), PROMPT, N_NEW)
    peng = PEngine(params, pcfg, pspec, quantized=True, store=store,
                   device="cpu", **flags)
    steps = []
    ptoks, pstats = peng.generate(
        PROMPT, N_NEW, on_step=lambda lg, r: steps.append((lg[0].numpy(), r)))
    np.testing.assert_array_equal(ptoks, jtoks)
    for i, ((plg, proute), jlg, jr) in enumerate(zip(steps, jlogits, jroutes)):
        np.testing.assert_allclose(plg, jlg, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {i}")
        if jr is not None:
            for a, b in zip(jr, proute):
                np.testing.assert_array_equal(b, a)
    jc = np.asarray(jps.counts)
    assert (pstats.hits, pstats.spec_hits, pstats.demand_loads,
            pstats.spec_loads) == tuple(int(c) for c in jc)
    ps = peng._last_pool_state
    np.testing.assert_array_equal(np.stack([s.cache_ids for s in ps.lru]),
                                  np.asarray(jps.lru.cache_ids))
    np.testing.assert_array_equal(np.stack([s.spec_ids for s in ps.lru]),
                                  np.asarray(jps.lru.spec_ids))
    assert ps.h2d_bytes == pstats.bytes_h2d
    assert EP.pool_coherent(peng.store, ps)
    assert pstats.spec_hits > 0 and pstats.demand_loads > 0
    assert (ps.serve is None) == vectorized


def test_plain_plane_is_refused(quantized):
    """The plain plane keeps no expert pool, row chunks need a paged state,
    and per-row chunks on dense rings (the draft-and-verify rows) are not
    ported: each raises instead of computing something else.  The packed
    planes refuse the static engine's padded prefill."""
    from repro_torch.runtime.executor import Executor
    _, _, _, params, store, pcfg, pspec = quantized
    ex = Executor(params, pcfg, device="cpu", plane="plain")
    with pytest.raises(ValueError, match="packed planes only"):
        ex.init_pool_state()
    dense = ex.init_state(1, 8)
    with pytest.raises(ValueError, match="paged-KV"):
        ex.prefill_chunk_row(dense, torch.zeros((1, 2), dtype=torch.int32), 0)
    rows = dict(dense, pos=np.zeros(1, np.int32))
    with pytest.raises(NotImplementedError, match="item 4"):
        ex.decode(rows, torch.zeros((1, 2), dtype=torch.int32))
    packed = Executor(params, pcfg, spec=pspec, store=store, device="cpu",
                      plane="packed_vectorized")
    with pytest.raises(ValueError, match="chunks"):
        packed.prefill_padded({"tokens": np.ones((1, 4), np.int32)}, 8)


def _record(st, l, s, vectorized):
    """The bytes of record ``s`` of :func:`EP.served` (``st``, ``l``)."""
    if vectorized:
        return st.pool.flat[l * st.pool.n_slots + s]
    return st.serve.record(0, s)


@pytest.mark.parametrize("T", [1, 3])
def test_unrolled_pool_matches_vectorized(quantized, T):
    """Random traces through both data planes of the port: T rows (some
    inactive when T > 1), and at T = 1 each access followed by a stage of
    the other layer, as batch-1 decode does."""
    *_, store, pcfg, pspec = quantized
    rng = np.random.default_rng(T)
    E, K = pcfg.moe.num_experts, pcfg.moe.top_k
    cpu = torch.device("cpu")
    vec = EP.init_pool_state(store, pspec, cpu, max_rows=T * K)
    unr = EP.init_pool_state(store, pspec, cpu, max_rows=T * K,
                             vectorized=False)
    assert unr.pool.n_extra == 0 and unr.serve.n_slots == T * K
    for step in range(16):
        l = step % 2
        ids = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        active = None if T == 1 else rng.random(T) < 0.7
        rows = range(T) if active is None else np.flatnonzero(active)
        want = [store.record(l, int(e)) for t in rows for e in ids[t]]
        pred = rng.permutation(E)[: pspec.num_speculative]
        for st, v in ((vec, True), (unr, False)):
            slots = EP.acquire(store, st, l, ids, active, vectorized=v)
            got = [_record(st, l, int(s), v) for s in slots]
            assert len(got) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            if T == 1:
                EP.stage(store, st, 1 - l, pred, vectorized=v)
        np.testing.assert_array_equal(unr.counts, vec.counts)
        for a, b in zip(unr.lru, vec.lru):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert unr.h2d_bytes == vec.h2d_bytes
        assert EP.pool_coherent(store, unr) and EP.pool_coherent(store, vec)
    assert vec.counts[2] > 0 and (T > 1 or vec.counts[1] > 0)
    assert vec.h2d_bytes == (vec.counts[2] + vec.counts[3]) * \
        EP.per_expert_nbytes(store)


def test_unrolled_pool_needs_its_serve_tier(quantized):
    *_, store, pcfg, pspec = quantized
    st = EP.init_pool_state(store, pspec, torch.device("cpu"), max_rows=2)
    with pytest.raises(ValueError, match="vectorized=False"):
        EP.acquire(store, st, 0, np.array([[1, 2]]), vectorized=False)
