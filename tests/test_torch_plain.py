"""The port's plain plane and accounting mode against the JAX reference's,
on the CPU, with the same seeded weights crossed over by
``repro_torch.bridge``.

* ``generate_plain`` (dense resident weights, MoE by the per-token gather,
  dense MLP blocks) on ``tiny-moe`` and ``tiny-draft`` (cut to 2 layers),
  whole-prompt and in chunks of 4: equal tokens; every step's logits
  within atol 1e-4 (float32, the same products summed in another order)
  and every MoE layer's routed ids equal to the reference's
  ``decode_step(moe_mode="gather", collect_info=True)``.
* ``OffloadEngine(quantized=False)`` and ``(quantized=True,
  packed=False)``: tokens, ``OffloadStats`` and the ``usage`` histogram
  equal to the reference's; tokens bitwise equal to the port's own
  ``generate_plain`` over the same weights.  The packed engine's counters
  equal the accounting replay's.
* ``quantize_for_offload``'s ``size_report`` equal to the reference's;
  ``dense_from_store`` bitwise equal to ``pack_experts=False``.
* Sampling: ``rng=None`` falls back to a seeded generator on both modes
  (the reference's regression), ``SamplerConfig("greedy")`` equals
  greedy, top-k draws lie in that step's top k.
* ``apply_mlp`` in its three forms; a bfloat16 head_dim-64 model against
  the reference, where a difference must start at a near-tie (a routing
  decision whose top-k probability gap, or a token whose top-2 logit
  gap over the largest |logit|, is below 2^-6).
* Fault F1: prompt chunks that wrap the sliding-window ring equal
  token-by-token decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import offload_engine as JOE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.core import offload_engine as POE
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.runtime.executor import Executor
from repro_torch.serving.sampler import SamplerConfig

PROMPT = np.array([[72, 101, 108, 108, 111, 32, 119, 3, 250]], np.int32)
N_NEW = 10
LOGIT_ATOL = 1e-4
NEAR_TIE = 2.0 ** -6


def port_params(params, cfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                    "cpu")


@pytest.fixture(scope="module", params=["tiny-moe", "tiny-draft"])
def model(request):
    jcfg = jget(request.param).replace(n_layers=2)
    pcfg = pget(request.param).replace(n_layers=2)
    params = JT.init_model(jax.random.key(5), jcfg)
    return jcfg, pcfg, params, port_params(params, pcfg)


@pytest.fixture(scope="module")
def moe():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    return jcfg, pcfg, params, port_params(params, pcfg)


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
def test_generate_plain_tokens_match(model, chunk):
    jcfg, pcfg, params, pp = model
    want = JOE.generate_plain(params, jcfg, PROMPT, N_NEW, prefill_chunk=chunk)
    got = POE.generate_plain(pp, pcfg, PROMPT, N_NEW, prefill_chunk=chunk,
                             device="cpu")
    np.testing.assert_array_equal(got, want)


def _reference_routes(cfg, info_stack):
    """(ids, probs) per MoE layer of one reference ``decode_step`` info."""
    out = []
    for per in range(cfg.n_periods):
        for i in range(cfg.pattern_period):
            r = info_stack[i].get("route")
            if r is not None:
                out.append((np.asarray(r["ids"][per]),
                            np.asarray(r["probs"][per], np.float32)))
    return out


def _port_routes(infos):
    return [(i["route"]["ids"].numpy(), i["route"]["probs"].float().numpy())
            for i in infos if "route" in i]


def greedy_traces(jcfg, pcfg, params, pp, n_new):
    """Both sides' greedy loops through their plain steps with routing
    info: per step (logits of the last position, [(ids, probs)] per MoE
    layer, token); step 0 is the whole-prompt prefill."""
    jstep = jax.jit(lambda p, st, tk: JT.decode_step(
        p, jcfg, st, tk, moe_mode="gather", collect_info=True))
    max_len = PROMPT.shape[1] + n_new
    jst = JT.init_decode_state(jcfg, 1, max_len)
    pst = PT.init_decode_state(pcfg, 1, max_len, "cpu")
    jtok, ptok = jnp.asarray(PROMPT), torch.from_numpy(PROMPT)
    jsteps, psteps = [], []
    for _ in range(n_new):
        jl, jst, (jinfo, _) = jstep(params, jst, jtok)
        pl, pst, pinfo = PT.decode_step(pp, pcfg, pst, ptok, collect_info=True)
        jlast = np.asarray(jl[0, -1], np.float32)
        plast = pl[0, -1].float().numpy()
        jsteps.append((jlast, _reference_routes(jcfg, jinfo), int(jlast.argmax())))
        psteps.append((plast, _port_routes(pinfo), int(plast.argmax())))
        jtok = jnp.asarray([[jsteps[-1][2]]], jnp.int32)
        ptok = torch.tensor([[psteps[-1][2]]], dtype=torch.int32)
    return jsteps, psteps


def _gap(p, k):
    """The gap between the k-th and (k+1)-th largest of each row of p."""
    s = -np.sort(-p, axis=-1)
    return s[..., k - 1] - s[..., k]


def first_difference(jsteps, psteps, top_k):
    """None when both runs agree; else (what, gap) of the first routing or
    token decision that differs, with the larger of the two runs' gaps at
    that decision: between the k-th and (k+1)-th routing probabilities,
    or between the two largest logits over the largest |logit| (a
    probability gap over the whole vocabulary would be tiny whatever the
    logits)."""
    for i, ((jl, jr, jt), (pl, pr, pt)) in enumerate(zip(jsteps, psteps)):
        for l, ((ji, jp), (pi, pp)) in enumerate(zip(jr, pr)):
            rows = np.flatnonzero((np.sort(ji, -1) != np.sort(pi, -1)).any(-1))
            if rows.size:
                r = rows[0]
                return (f"step {i} layer {l} row {r}: experts {pi[r]} vs "
                        f"{ji[r]}", max(_gap(jp[r], top_k), _gap(pp[r], top_k)))
        if jt != pt:
            rel = lambda x: _gap(x, 1) / np.abs(x).max()
            return f"step {i}: token {pt} vs {jt}", max(rel(jl), rel(pl))
    return None


def test_plain_logits_and_routes_match(model):
    """Every step's logits within LOGIT_ATOL and every MoE layer's routed
    ids equal to the reference's plain step with routing info."""
    jcfg, pcfg, params, pp = model
    jsteps, psteps = greedy_traces(jcfg, pcfg, params, pp, N_NEW)
    assert first_difference(jsteps, psteps, 2) is None
    for (jl, jr, _), (pl, pr, _) in zip(jsteps, psteps):
        np.testing.assert_allclose(pl, jl, atol=LOGIT_ATOL)
        assert len(jr) == len(pr) == (2 if jcfg.moe else 0)
        for (ji, jp), (pi, ppr) in zip(jr, pr):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_allclose(ppr, jp, atol=1e-5)


def test_executor_plain_plane_steps(moe):
    """``Executor`` on the plain plane: ``decode_sampled`` gives the
    argmax of ``decode``'s logits, or the logits themselves; the infos
    carry the routing of every MoE layer; ``generate_greedy`` is
    ``generate_plain``."""
    _, pcfg, _, pp = moe
    ex = Executor(pp, pcfg, device="cpu")
    assert ex.plane == "plain" and not ex.packed
    logits, st = ex.prefill(PROMPT, 16)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    lg, st, ps, infos = ex.decode(st, tok, collect_info=True)
    assert ps is None and len(infos) == pcfg.n_layers
    assert st["pos"] == PROMPT.shape[1] + 1
    assert all(i["route"]["ids"].shape == (1, 2) for i in infos)
    nxt, _ = ex.decode_sampled(
        ex.prefill(PROMPT, 16)[1], tok, collect_info=False, greedy=True)
    assert int(nxt[0]) == int(torch.argmax(lg[0, -1]))
    last, _ = ex.decode_sampled(ex.prefill(PROMPT, 16)[1], tok,
                                collect_info=False, greedy=False)
    np.testing.assert_array_equal(last.numpy(), lg[:, -1].numpy())
    np.testing.assert_array_equal(
        ex.generate_greedy(PROMPT, 6),
        POE.generate_plain(pp, pcfg, PROMPT, 6, device="cpu"))


@pytest.fixture(scope="module")
def accounting(moe):
    """Both sides' accounting engines over the same weights, plain
    (``quantized=False``) and over the dequantized model
    (``quantized=True, packed=False``), each run for N_NEW + 2 tokens."""
    jcfg, pcfg, params, pp = moe
    out = {}
    for name, kw in (("plain", dict(quantized=False)),
                     ("dequantized", dict(quantized=True, packed=False))):
        je = JOE.OffloadEngine(params, jcfg, jcfg.offload, **kw)
        pe = POE.OffloadEngine(pp, pcfg, pcfg.offload, device="cpu", **kw)
        out[name] = (je, je.generate(PROMPT, N_NEW + 2),
                     pe, pe.generate(PROMPT, N_NEW + 2))
    return out


COUNTERS = ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads",
            "expert_bytes", "accesses", "hit_ratio", "bytes_h2d")


@pytest.mark.parametrize("mode", ["plain", "dequantized"])
def test_accounting_matches_reference(moe, accounting, mode):
    _, pcfg, _, _ = moe
    je, (jtok, js), pe, (ptok, ps) = accounting[mode]
    np.testing.assert_array_equal(ptok, jtok)
    for f in COUNTERS:
        assert getattr(ps, f) == getattr(js, f), f
    assert ps.spec_hits > 0 and ps.demand_loads > 0 and ps.hits > 0
    np.testing.assert_array_equal(pe.usage.counts, je.usage.counts)
    assert (je.size_report is None) == (pe.size_report is None)
    if pe.size_report is not None:
        assert pe.size_report == je.size_report
    # pure scheduling: the tokens of the plain plane over the same weights
    np.testing.assert_array_equal(
        ptok, POE.generate_plain(pe.params, pcfg, PROMPT, N_NEW + 2,
                                 device="cpu"))


@pytest.fixture(scope="module")
def packed(moe):
    """Both sides' ``quantize_for_offload(..., pack_experts=True)`` of the
    ``moe`` weights, quantized once: the reference's size report, and
    the port's executable weights, size report and packed store."""
    jcfg, pcfg, params, pp = moe
    jrep = JOE.quantize_for_offload(params, jcfg, jcfg.offload,
                                    pack_experts=True)[1]
    return (jrep,) + POE.quantize_for_offload(pp, pcfg, pcfg.offload,
                                              pack_experts=True, device="cpu")


def _packed_engine(pcfg, packed):
    _, exec_params, _, store = packed
    return POE.OffloadEngine(exec_params, pcfg, pcfg.offload, quantized=True,
                             store=store, device="cpu")


@pytest.mark.parametrize("pack", [False, True], ids=["dense", "packed"])
def test_size_report_matches_reference(accounting, packed, pack):
    if pack:
        want, _, got, _ = packed
    else:
        je, _, pe, _ = accounting["dequantized"]
        want, got = je.size_report, pe.size_report
    assert got == want
    assert got["attn"] > 0 and got["experts"] > 0


def test_dense_from_store_equals_dense_quantization(moe, accounting, packed):
    """Dequantizing the packed store gives bitwise the experts (and every
    other weight) of ``quantize_for_offload(pack_experts=False)`` (the
    dequantized accounting engine's weights)."""
    _, pcfg, _, _ = moe
    dense = accounting["dequantized"][2].params
    _, exec_params, _, store = packed
    assert "experts" not in exec_params["layers"][0]["moe"]
    got = POE.dense_from_store(exec_params, pcfg, store, "cpu")
    a, b = list(_flatten(got)), list(_flatten(dense))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    else:
        yield path, tree


def test_packed_counters_match_accounting_replay(moe, accounting, packed):
    """The port's counterpart of the reference's: the packed engine's pool
    counters equal the PyLRU replay of an accounting engine over the
    dequantized model, with the same tokens and ``usage``."""
    _, pcfg, _, _ = moe
    eng = _packed_engine(pcfg, packed)
    acct = POE.OffloadEngine(accounting["dequantized"][2].params, pcfg,
                             pcfg.offload, device="cpu")
    tp, sp = eng.generate(PROMPT, 12)
    ta, sa = acct.generate(PROMPT, 12)
    np.testing.assert_array_equal(tp, ta)
    for f in ("n_tokens", "hits", "spec_hits", "demand_loads", "spec_loads"):
        assert getattr(sp, f) == getattr(sa, f), f
    np.testing.assert_array_equal(eng.usage.counts, acct.usage.counts)


@pytest.mark.parametrize("quantized", [True, False], ids=["packed", "accounting"])
def test_sampled_generate_without_rng(moe, packed, quantized):
    """The reference's regression: ``greedy=False`` without an rng draws
    from a generator seeded with 0 (so it repeats); a given generator
    reproduces too; greedy through ``SamplerConfig("greedy")`` is greedy;
    top-k draws lie in their step's top k."""
    _, pcfg, _, pp = moe
    eng = (_packed_engine(pcfg, packed) if quantized else
           POE.OffloadEngine(pp, pcfg, pcfg.offload, device="cpu"))
    a, _ = eng.generate(PROMPT, 6, greedy=False)
    b, _ = eng.generate(PROMPT, 6, greedy=False)
    assert a.shape == (1, 6) and ((0 <= a) & (a < pcfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)
    gen = lambda: torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        eng.generate(PROMPT, 6, greedy=False, rng=gen())[0], a)
    np.testing.assert_array_equal(
        eng.generate(PROMPT, 6, sampler=SamplerConfig("greedy"))[0],
        eng.generate(PROMPT, 6)[0])
    logits = []
    toks, _ = eng.generate(PROMPT, 6, rng=gen(),
                           sampler=SamplerConfig("topk", top_k=3),
                           on_step=lambda lg, r: logits.append(lg[0]))
    for t, lg in zip(toks[0], logits):
        assert t in torch.topk(lg, 3).indices.tolist()


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_reference(act):
    cfg = jget("tiny-draft").replace(mlp_act=act)
    p = JL.init_mlp(jax.random.key(2), cfg)
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)
                                                 ).astype(np.float32)
    want = np.asarray(JL.apply_mlp(p, cfg, jnp.asarray(x)))
    got = PL.apply_mlp({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                       cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_model_builds_mlp_blocks():
    """``tiny-draft`` (``attn+mlp``) initialises dense MLP blocks with the
    reference's shapes and generates."""
    cfg = pget("tiny-draft")
    params = PT.init_model(cfg, seed=0, device="cpu")
    mlp = params["layers"][0]["mlp"]
    assert {k: tuple(v.shape) for k, v in mlp.items()} == {
        "w_gate": (128, 256), "w_up": (128, 256), "w_down": (256, 128)}
    assert "moe" not in params["layers"][0]
    out = POE.generate_plain(params, cfg, PROMPT, 4, device="cpu")
    assert out.shape == (1, 4)


def test_bf16_head_dim_64_matches_reference_to_a_near_tie():
    """``tiny-moe`` with 4 heads over 2 KV heads (head_dim 64) in
    bfloat16, the shape every tensor-core route of the card takes, on the
    plain plane against the reference: equal, or the first difference is
    a near-tie, a routing decision whose top-k probability gap (or a token
    whose top-2 logit gap over its largest |logit|) is below 2^-6 in both
    runs."""
    change = dict(n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                  dtype="bfloat16")
    jcfg, pcfg = jget("tiny-moe").replace(**change), pget("tiny-moe").replace(**change)
    assert pcfg.head_dim == 64
    params = JT.init_model(jax.random.key(7), jcfg)
    pp = port_params(params, pcfg)
    assert pp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    jsteps, psteps = greedy_traces(jcfg, pcfg, params, pp, N_NEW)
    diff = first_difference(jsteps, psteps, jcfg.moe.top_k)
    print("bf16 plain plane vs reference:", diff or "equal")
    assert diff is None or diff[1] < NEAR_TIE, diff


@pytest.mark.parametrize("C", [2, 3, 4, 8])
def test_wrapped_chunks_match_token_by_token(moe, C):
    """Fault F1: chunks of C tokens through an 8-wide sliding-window ring
    from position 0 to 24, wrapped chunks included, give the outputs of
    token-by-token decode (the port's and the reference's) within 1e-5,
    and leave the ring and its positions as the reference's chunks do."""
    jcfg, pcfg, params, pp = moe
    jcfg, pcfg = jcfg.replace(sliding_window=8), pcfg.replace(sliding_window=8)
    p = JT.layer_params(params, jcfg, 0)["attn"]
    q = pp["layers"][0]["attn"]
    x = np.random.default_rng(C).standard_normal((1, 24, jcfg.d_model)
                                                 ).astype(np.float32)
    jstep = jax.jit(lambda xc, c, pos: JL.attention_decode(p, jcfg, xc, c, pos,
                                                            window=8))
    jc = JL.init_attn_cache(jcfg, 1, 64, window=8)
    jd = JL.init_attn_cache(jcfg, 1, 64, window=8)
    pc = PL.init_attn_cache(pcfg, 1, 64, "cpu", window=8)
    pd = PL.init_attn_cache(pcfg, 1, 64, "cpu", window=8)
    wrapped = 0
    for pos in range(0, 24 - C + 1, C):
        xc = x[:, pos:pos + C]
        y, pc = PL.attention_decode(q, pcfg, torch.from_numpy(xc), pc, pos,
                                    window=8)
        _, jc = jstep(jnp.asarray(xc), jc, jnp.asarray(pos, jnp.int32))
        for j in range(C):
            yp, pd = PL.attention_decode(q, pcfg, torch.from_numpy(xc[:, j:j + 1]),
                                         pd, pos + j, window=8)
            yj, jd = jstep(jnp.asarray(xc[:, j:j + 1]), jd,
                           jnp.asarray(pos + j, jnp.int32))
            np.testing.assert_allclose(y[:, j].numpy(), yp[:, 0].numpy(),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(y[:, j].numpy(), np.asarray(yj)[:, 0],
                                       atol=1e-5, rtol=0)
        wrapped += pos + C > 8
        np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(pc["v"].numpy(), np.asarray(jc["v"]),
                                   atol=1e-5, rtol=0)
    assert wrapped >= 2
