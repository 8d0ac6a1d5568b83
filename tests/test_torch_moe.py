"""Layer-level parity of the port's MoE and attention modules with the
JAX reference, on ``tiny-moe`` (2 layers), seeded, on the CPU: the
gather oracle, the store-direct prefill MoE, the pooled decode MoE with
speculative staging over several tokens, and the dense KV ring with
wrapped chunk writes.  Float tolerance 1e-5 (float32, other summation
order); ids, counters and LRU state exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core import expert_pool as JEP
from repro.core.trace import stacked_routers
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as PEP
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM

from test_torch_offload import store_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(3), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    return jcfg, pcfg, params, pparams


@pytest.fixture(scope="module")
def stores(model):
    """Both sides' packed stores per bit width, quantized once by the
    reference."""
    jcfg, pcfg, params, _ = model
    out = {}
    for bits in (3, 2):
        jspec = JSpec(cache_size=2, num_speculative=2, expert_bits=bits)
        pspec = PSpec(**dataclasses.asdict(jspec))
        jstore = JEP.build_store(params, jcfg, jspec)
        pstore = bridge.store_from_numpy(store_leaves(jstore), pcfg, pspec,
                                         "cpu")
        out[bits] = (jspec, pspec, jstore, pstore)
    return out


def _x(T, D, seed):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)


def test_moe_gather_oracle_matches(model):
    jcfg, pcfg, params, pparams = model
    p = JT.layer_params(params, jcfg, 1)["moe"]
    pp = dict(pparams["layers"][1]["moe"])
    pp["experts"] = {k: torch.from_numpy(np.array(v))
                     for k, v in p["experts"].items()}
    x = _x(5, jcfg.d_model, 0)
    yj, rj = JM.moe_apply_gather(p, jcfg, jnp.asarray(x))
    yp, rp = PM.moe_apply_gather(pp, pcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(rp["ids"].numpy(), np.asarray(rj["ids"]))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("bits", [3, 2])
def test_moe_packed_stream_matches(model, stores, bits):
    """Prefill MoE: distinct experts into the tier, rows sorted into
    ragged groups by expert (no padding), the grouped binding over the
    tier."""
    jcfg, pcfg, params, pparams = model
    _, _, jstore, pstore = stores[bits]
    tier = PEP.PrefillTier.for_store(pstore, "cpu")
    for l in range(2):
        p = JT.layer_params(params, jcfg, l)["moe"]
        x = _x(9, jcfg.d_model, 10 + l)
        yj, rj = JM.moe_apply_packed_stream(p, jcfg, jnp.asarray(x), jstore,
                                            jnp.asarray(l, jnp.int32))
        yp, rp = PM.moe_apply_packed_stream(pparams["layers"][l]["moe"], pcfg,
                                            torch.from_numpy(x), pstore, l,
                                            tier)
        np.testing.assert_array_equal(rp["ids"].numpy(), np.asarray(rj["ids"]))
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    assert tier.host_reads == 2


def test_prefill_tier_records_group_counts(model, stores):
    """``PrefillTier.batches`` keeps, per MoE call, the rows of each
    distinct routed expert in the tier's slot order (ascending expert
    id): the ragged groups the grouped kernel ran, unpadded."""
    jcfg, pcfg, params, pparams = model
    _, _, _, pstore = stores[2]
    tier = PEP.PrefillTier.for_store(pstore, "cpu")
    x = _x(13, jcfg.d_model, 7)
    _, rp = PM.moe_apply_packed_stream(pparams["layers"][0]["moe"], pcfg,
                                       torch.from_numpy(x), pstore, 0, tier)
    _, counts = np.unique(rp["ids"].numpy(), return_counts=True)
    assert list(tier.batches) == [tuple(counts.tolist())]
    assert sum(tier.batches[0]) == 13 * pcfg.moe.top_k


@pytest.mark.parametrize("bits", [3, 2])
def test_moe_packed_decode_with_staging_matches(model, stores, bits):
    """Decode MoE over the pool, token after token through both layers,
    with layer 0 staging layer 1's predicted experts: outputs, routed ids,
    counters and LRU state as the reference's; the pool stays coherent."""
    jcfg, pcfg, params, pparams = model
    jspec, pspec, jstore, pstore = stores[bits]
    jps = JEP.init_pool_state(jstore, jspec)
    pps = PEP.init_pool_state(pstore, pspec, torch.device("cpu"), max_rows=2)
    jr = jnp.asarray(stacked_routers(params, jcfg))
    pr = torch.from_numpy(np.asarray(jr))
    for step in range(5):
        for l in range(2):
            p = JT.layer_params(params, jcfg, l)["moe"]
            x = _x(1, jcfg.d_model, 100 * step + l)
            yj, rj, jps = JM.moe_apply_packed(
                p, jcfg, jnp.asarray(x), jstore, jps,
                jnp.asarray(l, jnp.int32), jr, lookahead=1, n_spec=2)
            yp, rp, pps = PM.moe_apply_packed(
                pparams["layers"][l]["moe"], pcfg, torch.from_numpy(x),
                pstore, pps, l, pr, lookahead=1, n_spec=2)
            np.testing.assert_array_equal(rp["ids"], np.asarray(rj["ids"]))
            np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(pps.counts, np.asarray(jps.counts))
    np.testing.assert_array_equal(np.stack([s.cache_ids for s in pps.lru]),
                                  np.asarray(jps.lru.cache_ids))
    assert PEP.pool_coherent(pstore, pps)
    assert pps.counts[1] > 0  # speculative hits happened
    assert pps.h2d_bytes == (pps.counts[2] + pps.counts[3]) * \
        PEP.per_expert_nbytes(pstore)


def test_attention_ring_wraps_like_reference(model):
    """Chunks of 3 tokens written into an 8-wide SWA ring from position 0
    to 24: ring contents and positions as the reference's; outputs equal
    to the reference's token-by-token decode of the same inputs (the
    reference's own wrapped chunks lose keys, ROADMAP queue 3 F1)."""
    jcfg, pcfg, params, pparams = model
    jcfg, pcfg = jcfg.replace(sliding_window=8), pcfg.replace(sliding_window=8)
    p = JT.layer_params(params, jcfg, 0)["attn"]
    pp = pparams["layers"][0]["attn"]
    jc = JL.init_attn_cache(jcfg, 1, 64, window=8)
    jd = JL.init_attn_cache(jcfg, 1, 64, window=8)  # token by token
    pc = PL.init_attn_cache(pcfg, 1, 64, "cpu", window=8)
    for i, pos in enumerate(range(0, 24, 3)):
        x = np.random.default_rng(i).standard_normal(
            (1, 3, jcfg.d_model)).astype(np.float32)
        _, jc = JL.attention_decode(p, jcfg, jnp.asarray(x), jc,
                                    jnp.asarray(pos, jnp.int32), window=8)
        yd = []
        for j in range(3):
            y, jd = JL.attention_decode(p, jcfg, jnp.asarray(x[:, j:j + 1]),
                                        jd, jnp.asarray(pos + j, jnp.int32),
                                        window=8)
            yd.append(np.asarray(y))
        yp, pc = PL.attention_decode(pp, pcfg, torch.from_numpy(x), pc, pos,
                                     window=8)
        np.testing.assert_allclose(yp.numpy(), np.concatenate(yd, 1), **TOL)
        np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_stage_swaps_staging_buffers_without_transfers(stores):
    """Predictions already staged, in swapped order, move device-locally
    (through scratch: each buffer is the other's source) and charge
    nothing; repeated predictions are refused."""
    _, pspec, _, pstore = stores[3]
    ps = PEP.init_pool_state(pstore, pspec, torch.device("cpu"), max_rows=2)
    PEP.stage(pstore, ps, 1, np.array([4, 6]))
    assert ps.counts[3] == 2 and PEP.pool_coherent(pstore, ps)
    h2d = ps.h2d_bytes
    PEP.stage(pstore, ps, 1, np.array([6, 4]))
    assert ps.counts[3] == 2 and ps.h2d_bytes == h2d
    np.testing.assert_array_equal(ps.lru[1].spec_ids, [6, 4])
    assert PEP.pool_coherent(pstore, ps)
    with pytest.raises(ValueError):
        PEP.stage(pstore, ps, 1, np.array([3, 3]))
