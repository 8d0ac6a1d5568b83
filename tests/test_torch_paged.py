"""The port's paged-KV pieces against the JAX reference, on the CPU:
the ragged-attention module (work list and plain version), the paged
attention layer, and the expert pool's batched ``acquire`` over a pool
smaller than a batch's experts.

Tolerances: float32 attention within 2e-5 of the reference's plain
version and of its Pallas kernel in interpret mode (the same sums in
another order), 1e-5 for the layer's output; integer results (work
lists, written positions, plans, counters, LRU state, served bytes)
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core import expert_pool as JEP
from repro.kernels import ragged_attention as JRA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as PEP
from repro_torch.kernels import ragged_attention as PRA
from repro_torch.models import layers as PL
from repro_torch.quant import hqq as PH

from test_torch_offload import store_leaves

ATOL = 2e-5


def _tables(rng, lens, T, ps, spare=2):
    """Page tables for rows of live lengths ``lens`` over a shuffled pool
    of ``sum(pages) + spare`` pages (at most T pages a row); ppos holds
    each written position."""
    n_pages = sum(-(-n // ps) for n in lens)
    P = n_pages + spare
    ids = list(rng.permutation(P))
    pages = np.full((len(lens), T), -1, np.int32)
    ppos = np.full((P, ps), -1, np.int32)
    for b, n in enumerate(lens):
        for o in range(min(-(-n // ps), T)):
            pages[b, o] = pid = ids.pop()
            for j in range(min(ps, n - o * ps)):
                ppos[pid, j] = o * ps + j
    return pages, ppos


# ----------------------------------------------------------------------
# the kernel module
@pytest.mark.parametrize("seed", range(6))
def test_worklist_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ps, T, B = 4, 6, 5
    lens = rng.integers(0, T * ps + 1, B)
    pages, _ = _tables(rng, lens, T, ps)
    pages[rng.random(pages.shape) < 0.1] = -1  # holes in the tables
    C = int(rng.integers(1, 4))
    q_hi = np.maximum(lens - 1, 0)
    q_lo = np.maximum(q_hi - C + 1, 0)
    for window in (None, 3, 9):
        for pad_to in (None, 40):
            want = JRA.build_page_worklist(pages, lens, q_lo, q_hi, ps,
                                           window=window, pad_to=pad_to)
            got = PRA.build_page_worklist(pages, lens, q_lo, q_hi, ps,
                                          window=window, pad_to=pad_to)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_packed_worklist_segments_and_drops_padding():
    """The kernel's packed list: each row's segment range, the segments
    (row, lo, hi) of at most ``seg_pages`` listed pages, then the pages,
    padding dropped; an out-of-order list is refused."""
    pages = np.array([[3, 1, -1], [-1, -1, -1], [0, 2, 4]], np.int32)
    wl = PRA.build_page_worklist(pages, [8, 0, 10], [7, 0, 9], [7, 0, 9], 4,
                                 pad_to=9)
    packed, n_seg = PRA.pack_worklist(*wl, 3, seg_pages=2)
    assert n_seg == 3
    np.testing.assert_array_equal(
        packed, [0, 1, 1, 3, 0, 0, 2, 2, 2, 4, 2, 4, 5, 3, 1, 0, 2, 4])
    packed, n_seg = PRA.pack_worklist(*wl, 3)
    assert n_seg == 2
    np.testing.assert_array_equal(packed[:10], [0, 1, 1, 2, 0, 0, 2, 2, 2, 5])
    empty = PRA.build_page_worklist(pages, [0, 0, 0], 0, 0, 4)  # one inert entry
    packed, n_seg = PRA.pack_worklist(*empty, 3)
    assert n_seg == 0
    np.testing.assert_array_equal(packed, [0, 0, 0, 0])
    with pytest.raises(ValueError):
        PRA.pack_worklist(*(a[::-1] for a in wl), 3)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("C", [1, 2, 5])
def test_plain_ragged_attention_matches_reference_and_pallas(window, C):
    """The CPU dispatch (plain version) against the reference's plain
    version on every row, and against its Pallas kernel in interpret
    mode on the rows that have work (an idle row's output is undefined
    there); rows of several lengths, a row with no pages, padding."""
    rng = np.random.default_rng(10 * C + (window or 0))
    ps, T, Hkv, G, hd = 4, 5, 2, 2, 8
    lens = np.array([C + 6, 0, C + 1, C + 12])
    pages, ppos = _tables(rng, lens, T, ps)
    P = ppos.shape[0]
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    q = rng.standard_normal((len(lens), C, Hkv * G, hd)).astype(np.float32)
    qpos = (np.maximum(lens, C)[:, None] - C + np.arange(C)).astype(np.int32)
    wl = PRA.build_page_worklist(pages, lens, qpos[:, 0], qpos[:, -1], ps,
                                 window=window, pad_to=16)
    j = lambda a: jnp.asarray(a)
    ref = JRA.ragged_attention_reference(j(q), j(kp), j(vp), j(ppos),
                                         j(pages), j(qpos), window=window,
                                         q_chunk=C)
    pallas = JRA.ragged_attention_pallas(j(q), j(kp), j(vp), j(ppos),
                                         j(qpos), *map(j, wl), window=window,
                                         interpret=True)
    t = torch.from_numpy
    got = PRA.ragged_attention(t(q), t(kp), t(vp), t(ppos), t(pages),
                               t(qpos), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    busy = lens > 0
    np.testing.assert_allclose(got[busy], np.asarray(pallas)[busy], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("C", [1, 4])
def test_plain_ragged_attention_head_dim_96_matches_pallas(C):
    """head_dim 96 (phi-3-vision's, a new instance of both CUDA kernels):
    the CPU dispatch against the reference's plain version and its Pallas
    kernel in interpret mode, MHA and GQA 3, pages of 16."""
    for Hkv, G, window in ((4, 1, None), (2, 3, 20)):
        rng = np.random.default_rng(96 + C + G)
        ps, T, hd = 16, 4, 96
        lens = np.array([C + 30, 0, C + 3])
        pages, ppos = _tables(rng, lens, T, ps)
        P = ppos.shape[0]
        kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
        vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
        q = rng.standard_normal((len(lens), C, Hkv * G, hd)).astype(np.float32)
        qpos = (np.maximum(lens, C)[:, None] - C + np.arange(C)).astype(np.int32)
        wl = PRA.build_page_worklist(pages, lens, qpos[:, 0], qpos[:, -1], ps,
                                     window=window, pad_to=16)
        j = lambda a: jnp.asarray(a)
        ref = JRA.ragged_attention_reference(j(q), j(kp), j(vp), j(ppos),
                                             j(pages), j(qpos), window=window,
                                             q_chunk=C)
        pallas = JRA.ragged_attention_pallas(j(q), j(kp), j(vp), j(ppos),
                                             j(qpos), *map(j, wl),
                                             window=window, interpret=True)
        t = torch.from_numpy
        got = PRA.ragged_attention(t(q), t(kp), t(vp), t(ppos), t(pages),
                                   t(qpos), window=window).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
        busy = lens > 0
        np.testing.assert_allclose(got[busy], np.asarray(pallas)[busy],
                                   rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# the paged attention layer
@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(5), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    return jcfg, pcfg, params, pparams


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("C", [1, 3])
def test_attention_decode_paged_matches_reference(model, window, C):
    """Rows at their own positions: an active row, an inactive row and a
    row whose write falls on an unallocated table slot or past the table
    write nothing: the written ``ppos`` and the set of written K/V
    entries are the reference's exactly; the K/V values and the output
    agree within 1e-5 (the projections sum in another order)."""
    jcfg, pcfg, params, pparams = model
    rng = np.random.default_rng(C)
    ps, T, Hkv, hd = 4, 5, jcfg.n_kv_heads, jcfg.head_dim
    pos = np.array([5, 3, 6, 18], np.int32)
    active = np.array([True, False, True, True])
    pages, ppos = _tables(rng, pos + C, T, ps, spare=3)
    pages[2, 6 // ps + (1 if C > 2 else 0)] = -1  # row 2 writes (partly) nowhere
    for b in range(len(pos)):  # only positions before pos are written yet
        for o in range(T):
            if pages[b, o] >= 0:
                ppos[pages[b, o]][ppos[pages[b, o]] >= pos[b]] = -1
    P = ppos.shape[0]
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    x = rng.standard_normal((len(pos), C, jcfg.d_model)).astype(np.float32)
    p = JT.layer_params(params, jcfg, 0)["attn"]
    jy, jc = JL._attention_decode_paged(
        p, jcfg, jnp.asarray(x), {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
                                  "ppos": jnp.asarray(ppos)},
        jnp.asarray(pos), jnp.asarray(pages), window=window,
        active=jnp.asarray(active))
    cache = {"kp": torch.from_numpy(kp.copy()), "vp": torch.from_numpy(vp.copy()),
             "ppos": torch.from_numpy(ppos.copy())}
    py, pc = PL.attention_decode(pparams["layers"][0]["attn"], pcfg,
                                 torch.from_numpy(x), cache,
                                 torch.from_numpy(pos), window=window,
                                 pages=torch.from_numpy(pages),
                                 active=torch.from_numpy(active))
    np.testing.assert_array_equal(pc["ppos"].numpy(), np.asarray(jc["ppos"]))
    for name, before in (("kp", kp), ("vp", vp)):
        got, want = pc[name].numpy(), np.asarray(jc[name])
        np.testing.assert_array_equal(got != before, want != before)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (pc["ppos"].numpy() != ppos).sum() < active.sum() * C  # drops
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# the pool at T * K > cache_size
@pytest.fixture(scope="module")
def stores(model):
    jcfg, pcfg, params, _ = model
    jspec = JSpec(cache_size=2, num_speculative=2, expert_bits=3)
    pspec = PSpec(**dataclasses.asdict(jspec))
    jstore = JEP.build_store(params, jcfg, jspec)
    pstore = bridge.store_from_numpy(store_leaves(jstore), pcfg, pspec, "cpu")
    return jspec, pspec, jstore, pstore


@pytest.mark.parametrize("T", [2, 3])
def test_batched_acquire_matches_reference(stores, T):
    """Random traces of T rows of top-2 over a 2-slot pool, with row masks
    and speculative staging in between: the plans' counters and LRU state
    equal the reference's; every active access is served the bytes the
    reference serves it; the pool stays coherent; the h2d bytes issued
    equal the counters'; and accesses really lose their slot within
    their batch (served from the overflow tier)."""
    jspec, pspec, jstore, pstore = stores
    K = 2
    acquire = jax.jit(JEP.acquire, static_argnames=("vectorized",))
    stage = jax.jit(JEP.stage, static_argnames=("vectorized",))
    jps = JEP.init_pool_state(jstore, jspec)
    pps = PEP.init_pool_state(pstore, pspec, torch.device("cpu"),
                              max_rows=T * K)
    rng = np.random.default_rng(T)
    for step in range(10):
        for l in range(2):
            ids = np.stack([rng.choice(8, K, replace=False)
                            for _ in range(T)]).astype(np.int32)
            active = rng.random(T) < 0.75
            jps, served = acquire(jstore, jps, jnp.asarray(l, jnp.int32),
                                  jnp.asarray(ids), jnp.asarray(active))
            slots = PEP.acquire(pstore, pps, l, ids, active).numpy()
            np.testing.assert_array_equal(pps.counts, np.asarray(jps.counts))
            acc = [t * K + j for t in np.flatnonzero(active) for j in range(K)]
            mats = pps.pool.served(l)
            for jq, pq in zip(served, mats):
                for (_, ja), (_, pa) in zip(PH.leaves(jq), PH.leaves(pq)):
                    np.testing.assert_array_equal(pa[slots].numpy(),
                                                  np.asarray(ja)[acc])
            if l == 0 and step % 2:
                pred = rng.choice(8, 2, replace=False).astype(np.int32)
                jps = stage(jstore, jps, jnp.asarray(1, jnp.int32),
                            jnp.asarray(pred), True)
                PEP.stage(pstore, pps, 1, pred)
        np.testing.assert_array_equal(np.stack([s.cache_ids for s in pps.lru]),
                                      np.asarray(jps.lru.cache_ids))
        np.testing.assert_array_equal(np.stack([s.spec_ids for s in pps.lru]),
                                      np.asarray(jps.lru.spec_ids))
    c = pps.counts
    assert pps.h2d_bytes == (c[2] + c[3]) * PEP.per_expert_nbytes(pstore)
    assert PEP.pool_coherent(pstore, pps)
    assert pps.overflow_accesses > 0 and c[1] > 0



def test_overflow_tier_sized_to_batch(stores):
    """A pool whose batches hold at most ``cache_size`` accesses (batch 1
    of top-2 over 2 slots) gets no overflow records, and random batch-1
    traces never need one; a batch that would lose a slot on such a pool
    raises instead of indexing past it."""
    jspec, pspec, jstore, pstore = stores
    one = PEP.init_pool_state(pstore, pspec, torch.device("cpu"), max_rows=2)
    assert one.pool.n_extra == 0
    assert PEP.init_pool_state(pstore, pspec, torch.device("cpu"),
                               max_rows=4).pool.n_extra == 3
    rng = np.random.default_rng(5)
    for _ in range(20):
        ids = rng.choice(8, (1, 2), replace=False).astype(np.int32)
        PEP.acquire(pstore, one, 0, ids)
    assert one.overflow_accesses == 0
    assert PEP.pool_coherent(pstore, one)
    ids = np.asarray([[0, 1], [2, 3], [0, 1]], np.int32)  # 0, 1 evicted by 2, 3
    with pytest.raises(RuntimeError, match="overflow"):
        PEP.acquire(pstore, one, 1, ids)
