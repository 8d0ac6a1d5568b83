"""The port's offloaded generation against the JAX reference's, as a
whole, on ``tiny-moe`` cut to 2 layers, with 3- and 2-bit experts, on
the CPU.

The reference quantizes (``quantize_for_offload(..., pack_experts=True)``
inside its ``OffloadEngine(quantized=True)``) and generates on its
``packed_pipelined`` plane; its executable parameters and packed store
cross into the port through ``repro_torch.bridge``, so both sides hold
the same bytes.  Required: equal greedy tokens, equal ``OffloadStats``
counters and ``per_expert_nbytes``, equal routing ids per layer and step,
logits within atol 1e-4 in float32 (the same products summed in another
order), a coherent device pool and the h2d bytes actually issued equal to
the counters' ``bytes_h2d``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.models import transformer as JT
from repro_torch import bridge, resolve_device
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine

PROMPT = np.array([[72, 101, 108, 108, 111, 32, 119, 3, 250]], np.int32)
N_NEW = 12
LOGIT_ATOL = 1e-4


def reference_run(dec, prompt, n):
    """The reference's ``_generate_packed`` loop on its executor ``dec``,
    keeping the per-step logits and routing ids (what ``generate``
    discards)."""
    ps = dec.init_pool_state()
    pre, st, _ = dec.prefill(jnp.asarray(prompt), prompt.shape[1] + n)
    logits, routes = [np.asarray(pre[0, -1])], [None]
    tok = jnp.argmax(pre[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [int(tok[0, 0])]
    for _ in range(n - 1):
        lg, st, ps, rid = dec.decode(st, tok, ps)
        logits.append(np.asarray(lg[0, -1]))
        routes.append([np.asarray(r) for r in rid])
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(int(tok[0, 0]))
    return np.asarray(toks)[None], logits, routes, ps


def store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


@pytest.fixture(scope="module", params=[3, 2], ids=["3bit", "2bit"])
def runs(request):
    bits = request.param
    jcfg = jget("tiny-moe").replace(n_layers=2)
    jspec = JSpec(cache_size=2, num_speculative=2, lookahead=1,
                  expert_bits=bits, attn_bits=4)
    jeng = JEngine(JT.init_model(jax.random.key(0), jcfg), jcfg, jspec,
                   quantized=True)
    ref = reference_run(jeng._decoder, PROMPT, N_NEW)
    jtoks, jstats = jeng.generate(PROMPT, N_NEW)

    pcfg = pget("tiny-moe").replace(n_layers=2)
    pspec = PSpec(**dataclasses.asdict(jspec))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                      pcfg, "cpu")
    store = bridge.store_from_numpy(store_leaves(jeng.store), pcfg, pspec,
                                    "cpu")
    peng = PEngine(params, pcfg, pspec, quantized=True, store=store,
                   device="cpu")
    steps = []
    ptoks, pstats = peng.generate(
        PROMPT, N_NEW, on_step=lambda lg, r: steps.append((lg[0].numpy(), r)))
    return dict(jeng=jeng, ref=ref, jtoks=jtoks, jstats=jstats, peng=peng,
                ptoks=ptoks, pstats=pstats, steps=steps)


def divergence(ref, steps):
    """First step/layer where routing parts, and the largest logit gap
    there (the ROADMAP's divergence reporter); None when none parts."""
    _, jlogits, jroutes, _ = ref
    for i, ((plg, proute), jlg, jr) in enumerate(zip(steps, jlogits, jroutes)):
        gap = float(np.abs(plg - jlg).max())
        if jr is not None:
            for l, (a, b) in enumerate(zip(jr, proute)):
                if not (a == b).all():
                    return f"step {i} layer {l}: ids {b} vs {a}, logit gap {gap:.3g}"
        if gap > LOGIT_ATOL:
            return f"step {i}: logit gap {gap:.3g} > {LOGIT_ATOL}"
    return None


def test_tokens_routes_and_logits_match(runs):
    ref_toks = runs["ref"][0]
    np.testing.assert_array_equal(ref_toks, runs["jtoks"])  # loop == generate
    msg = divergence(runs["ref"], runs["steps"])
    assert msg is None, msg
    np.testing.assert_array_equal(runs["ptoks"], runs["jtoks"])


def test_offload_stats_match(runs):
    j, p = runs["jstats"], runs["pstats"]
    for f in ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads"):
        assert getattr(p, f) == getattr(j, f), f
    assert EP.per_expert_nbytes(runs["peng"].store) == \
        runs["jeng"].expert_bytes == p.expert_bytes
    assert p.bytes_h2d == j.bytes_h2d
    assert p.spec_hits > 0 and p.demand_loads > 0  # both paths exercised


def test_pool_coherent_and_lru_state_matches(runs):
    peng = runs["peng"]
    ps = peng._last_pool_state
    assert EP.pool_coherent(peng.store, ps)
    jps = runs["ref"][3]
    np.testing.assert_array_equal(np.stack([s.cache_ids for s in ps.lru]),
                                  np.asarray(jps.lru.cache_ids))
    np.testing.assert_array_equal(np.stack([s.spec_ids for s in ps.lru]),
                                  np.asarray(jps.lru.spec_ids))
    # the h2d copies actually issued are exactly what the counters charge
    assert ps.h2d_bytes == runs["pstats"].bytes_h2d
    # one routing read per MoE layer per decode step
    assert ps.host_reads == peng.n_moe_layers * (N_NEW - 1)


def test_chunked_prefill_matches_reference(runs):
    """Prefill in chunks of 4 against the reference's whole-prompt
    prefill: same tokens, logits within tolerance (the reference itself
    is not bitwise across chunkings under jax 0.9)."""
    steps = []
    toks, _ = runs["peng"].generate(
        PROMPT, 4, prefill_chunk=4,
        on_step=lambda lg, r: steps.append(lg[0].numpy()))
    np.testing.assert_array_equal(toks, runs["jtoks"][:, :4])
    np.testing.assert_allclose(steps[0], runs["ref"][1][0], atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-8x7b",
                                  "mixtral-offload", "tiny-draft"])
def test_config_copies_match_reference(name):
    j, p = jget(name), pget(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.padded_vocab == j.padded_vocab
    assert p.layer_kinds() == j.layer_kinds()
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(j.reduced())


def test_default_device_needs_a_gpu():
    """Entry points run on the card unless the caller asks for the CPU;
    with no card and no device they raise instead of falling back."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device(None)
    cfg = pget("tiny-moe").replace(n_layers=2)
    with pytest.raises(RuntimeError):
        PEngine({}, cfg)
    with pytest.raises(RuntimeError):
        PEngine({}, cfg, quantized=True, packed=False)
    from repro_torch.core.offload_engine import generate_plain
    from repro_torch.runtime.executor import Executor
    with pytest.raises(RuntimeError):
        Executor({}, cfg)
    with pytest.raises(RuntimeError):
        generate_plain({}, cfg, PROMPT, 2)


@pytest.mark.parametrize("change", [dict(mlp_act="geglu"),
                                    dict(norm="layernorm"),
                                    dict(qkv_bias=True),
                                    dict(n_layers=3, block_pattern=("swa+moe",
                                                                    "attn+moe"))],
                         ids=["geglu", "layernorm", "qkv-bias", "tail"])
def test_unported_configs_are_refused(change):
    """What the slice does not run raises instead of computing something
    else."""
    from repro_torch.models.transformer import init_model
    cfg = pget("tiny-moe").replace(**{"n_layers": 2, **change})
    with pytest.raises(NotImplementedError):
        init_model(cfg, device="cpu")
