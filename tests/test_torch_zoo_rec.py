"""The port's recurrent config zoo (``recurrentgemma-9b``: RG-LRU + SWA,
``xlstm-1.3b``: mLSTM + sLSTM) served and trained against the JAX
reference, on the CPU, at ``reduced()`` sizes in float32
(recurrentgemma: 3 layers, head_dim 64, window 16; xlstm: 6 layers,
mLSTM chunk 16).

* ``generate_plain`` tokens equal the reference's.
* ``ContinuousEngine`` (3 requests through 2 slots) on ``dense``,
  ``dense_chunked`` and ``paged``: each request's tokens equal the
  reference's B = 1 ``generate_plain`` stream (``parity.oracle_streams``,
  which the reference's own engine reproduces: ``tests/
  test_zoo_serving.py``); xlstm on pages runs a one-page pool and
  reserves no page.
* Draft-and-verify on dense slots (a random ``tiny-draft``, and a draft
  that proposes the oracle's own tokens, so that whole rounds are
  accepted and replayed) equals the oracle; on pages it is refused,
  naming the snapshot.
* Zero-page admission of a request larger than the pool, and the
  ``StateManager`` dispatch.
* Chunked prefill against the reference's whole prefill, within a
  tolerance (the reference's bitwise form of this claim is one of its
  own known failures).
* ``ServeEngine.serve_batch`` on equal lengths equals the reference's;
  unequal lengths are refused.
* One training step: the loss and every gradient within 1e-5 of the
  reference's (relative, per leaf).
* ``cost_model.recurrent_state_bytes`` equals the reference's at the
  published sizes.
* Rows outside ``active`` keep their carry bit for bit, dense and paged,
  and a paged row chunk writes its row alone.
* head_dim 256 (recurrentgemma's attention, MQA 16): the kernels' scopes
  take it, and the plain versions the card's kernels are held to match
  the reference's Pallas kernels in interpret mode.

Parameters are the reference-layout numpy draws of ``tests/zoo_models.py``
(with its recurrent init distributions); the reference's runs are shared
through module-scoped fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
import zoo_models as Z
from repro.configs import get_config as jget
from repro.core import cost_model as JCM
from repro.core.offload_engine import generate_plain as jgenerate
from repro.runtime.executor import Executor as JExecutor
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServe
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.core import cost_model as PCM
from repro_torch.core.offload_engine import generate_plain as pgenerate
from repro_torch.models import transformer as PT
from repro_torch.runtime.executor import Executor as PExecutor
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.engine import Request as PRequest
from repro_torch.serving.engine import ServeEngine as PServe
from repro_torch.serving.kv_manager import (KVSlotManager, PagedKVManager,
                                            StateManager)
from repro_torch.training import trainer as PTR

LENS = (5, 9, 11)  # + MAX_NEWS within the window of 16 (draft-and-verify)
MAX_NEWS = (6, 5, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return Z.Models()


@pytest.fixture(scope="module")
def oracles(models):
    """arch: (prompts, the reference's B = 1 greedy streams)."""
    out = {}
    for arch in Z.REC:
        jc, _, jp, _ = models(arch)
        prompts = parity.make_prompts(jc, LENS)
        out[arch] = (prompts, parity.oracle_streams(jp, jc, prompts,
                                                    list(MAX_NEWS)))
    return out


def _serve(pp, pc, prompts, **kw):
    eng = PContinuous(pp, pc, max_slots=2, slot_len=64, eos_id=None,
                      device="cpu", **kw)
    reqs = [eng.submit(p, m) for p, m in zip(prompts, MAX_NEWS)]
    eng.run(max_steps=400)
    assert all(r.state == "finished" for r in reqs)
    return [r.generated for r in reqs], eng


# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", Z.REC)
def test_generate_plain_matches_reference(models, arch):
    jc, pc, jp, pp = models(arch)
    prompt = Z.tokens(jc, 1, 11)
    want = np.asarray(jgenerate(jp, jc, prompt, 8))
    assert pgenerate(pp, pc, prompt, 8, device="cpu").tolist() == want.tolist()


@pytest.mark.parametrize("variant", ["dense", "dense_chunked", "paged"])
@pytest.mark.parametrize("arch", Z.REC)
def test_continuous_matches_oracle(models, oracles, arch, variant):
    _, pc, _, pp = models(arch)
    prompts, want = oracles[arch]
    kw = dict(parity.CONTINUOUS_KV_VARIANTS[variant])
    if variant == "paged" and not pc.has_kv_layers:
        kw["kv_pages_total"] = 1  # the zero-page path: one page serves all
    got, eng = _serve(pp, pc, prompts, **kw)
    parity.assert_tokens_equal(got, want, f"{arch}/{variant}")
    assert eng.sched.joins == len(prompts) > eng.max_slots
    eng.kv.check_invariants()
    if variant == "paged" and not pc.has_kv_layers:
        assert eng.kv.pool.peak_committed == 0 and eng.kv.pool.refs == {}


@pytest.mark.parametrize("draft", ["tiny-draft", "oracle"])
@pytest.mark.parametrize("arch", Z.REC)
def test_draft_and_verify_matches_oracle(models, oracles, arch, draft):
    """Each round snapshots the rows, verifies C = k + 1 tokens, restores
    and replays the accepted ones.  The "oracle" draft proposes the
    reference's own next tokens: every round is accepted whole and
    replays k + 1 tokens."""
    _, pc, _, pp = models(arch)
    prompts, want = oracles[arch]
    dcfg = pget("tiny-draft")
    eng = PContinuous(pp, pc, max_slots=2, slot_len=64, eos_id=None,
                      device="cpu", draft_params=PT.init_model(
                          dcfg, seed=1, device="cpu"),
                      draft_cfg=dcfg, num_draft_tokens=2)
    reqs = [eng.submit(p, m) for p, m in zip(prompts, MAX_NEWS)]
    if draft == "oracle":
        stream = {r.rid: w for r, w in zip(reqs, want)}
        propose = eng._draft_propose

        def oracle_propose(rs, k):
            props = propose(rs, k)
            return {r.slot: stream[r.rid][len(r.generated):][:k]
                    + props[r.slot][len(stream[r.rid][len(r.generated):]):]
                    for r in rs}

        eng._draft_propose = oracle_propose
    eng.run(max_steps=400)
    assert all(r.state == "finished" for r in reqs)
    parity.assert_tokens_equal([r.generated for r in reqs], want,
                               f"{arch}/draft={draft}")
    spec = eng.obs.snapshot()["spec"]
    assert spec["rounds"] > 0
    if draft == "oracle":
        assert spec["accepted"] == spec["proposed"]


def test_draft_and_verify_refused_on_pages(models):
    _, pc, _, pp = models("xlstm-1.3b")
    dcfg = pget("tiny-draft")
    with pytest.raises(ValueError, match="snapshot"):
        PContinuous(pp, pc, max_slots=2, slot_len=64, kv_page=16,
                    draft_params=PT.init_model(dcfg, seed=1, device="cpu"),
                    draft_cfg=dcfg, num_draft_tokens=2, device="cpu")


def test_zero_page_admission_not_refused(models):
    """A pure-recurrent request larger than the whole page pool admits:
    it needs no page."""
    _, pc, _, pp = models("xlstm-1.3b")
    eng = PContinuous(pp, pc, max_slots=2, slot_len=64, eos_id=None,
                      kv_page=16, kv_pages_total=1, device="cpu")
    assert eng.kv.can_admit(40)  # prompt + max_new >> the pool's 16
    req = eng.submit(parity.make_prompts(pc, [30])[0], 10)
    eng.run(max_steps=100)
    assert req.state == "finished" and len(req.generated) == 10
    assert eng.kv.pool.owned.get(req.slot, []) == []


def test_statemanager_dispatch(models):
    _, pc, _, _ = models("xlstm-1.3b")
    dense = StateManager.create(pc, 2, 32, device="cpu")
    paged = StateManager.create(pc, 2, 32, kv_page=8, device="cpu")
    assert isinstance(dense, KVSlotManager)
    assert isinstance(paged, PagedKVManager) and not paged.has_kv
    with pytest.raises(ValueError, match="kv_page"):
        StateManager.create(pc, 2, 32, kv_pages_total=4, device="cpu")
    _, gc, _, _ = models("recurrentgemma-9b")
    assert StateManager.create(gc, 2, 32, kv_page=8, device="cpu").has_kv


# ----------------------------------------------------------------------
def _ref_layer(jstate, cfg, l):
    """Layer l's decode state in the reference's stacked layout."""
    n_body = cfg.n_periods * cfg.pattern_period
    if l >= n_body:
        return jstate["tail"][l - n_body]
    blk = jstate["stack"][l % cfg.pattern_period]
    return jax.tree.map(lambda a: a[l // cfg.pattern_period], blk)


@pytest.mark.parametrize("arch", Z.REC)
def test_chunked_prefill_matches_whole_prefill(models, arch):
    """The port's prefill in chunks of 1, 3 and 4 (and whole) against the
    reference's whole-prompt prefill: last logits and every recurrent
    carry and ring within 1e-4 (an 11-step carry through 6 layers, in
    float32, from inputs that differ by ~1e-6)."""
    jc, pc, jp, pp = models(arch)
    prompt = parity.make_prompts(jc, [11], seed=4)[0][None]
    want_l, want_s = JExecutor(jp, jc).prefill(prompt, 24)[:2]
    ex = PExecutor(pp, pc, device="cpu")
    for c in (None, 1, 3, 4):
        with torch.no_grad():
            got_l, got_s = ex.prefill(prompt, 24, chunk=c)
        np.testing.assert_allclose(got_l[:, -1].numpy(),
                                   np.asarray(want_l[:, -1]), rtol=0,
                                   atol=1e-4, err_msg=f"chunk {c}")
        assert int(got_s["pos"]) == int(want_s["pos"]) == 11
        for l, blk in enumerate(got_s["layers"]):
            ref = _ref_layer(want_s, jc, l)
            for plane, leaves in blk.items():
                for k, t in leaves.items():
                    np.testing.assert_allclose(
                        t.numpy(), np.asarray(ref[plane][k]), rtol=1e-4,
                        atol=1e-4, err_msg=f"chunk {c} layer {l} {k}")


@pytest.mark.parametrize("arch", Z.REC)
def test_serve_batch_matches_reference(models, arch):
    jc, pc, jp, pp = models(arch)
    prompts = parity.make_prompts(jc, [7, 7, 7], seed=6)
    want = JServe(jp, jc).serve_batch([JRequest(p, 5) for p in prompts])
    got = PServe(pp, pc, device="cpu").serve_batch(
        [PRequest(p, 5) for p in prompts])
    assert [r.completed for r in got] == [r.completed for r in want]
    with pytest.raises(ValueError, match="causal-attention"):
        PServe(pp, pc, device="cpu").serve_batch(
            [PRequest(p, 5) for p in parity.make_prompts(jc, [5, 7])])


# the relative gradient error allowed per leaf: the 1e-5 of the other
# stacks where float32 holds the reference to it; on xlstm its own
# gradients move by up to ~6e-5 of a leaf (wq, wk), ~3e-4 for the small
# gate biases bi, bf, when its mLSTM chunk goes from 16 to 8 or 32, an
# exact regrouping in real arithmetic (the port's move ~5e-6 and ~2e-4)
GRAD_RTOL = {"recurrentgemma-9b": (1e-5, 1e-5), "xlstm-1.3b": (2e-4, 1e-3)}


@pytest.mark.parametrize("arch", Z.REC)
def test_train_step_gradients_match(models, arch):
    """The loss within 1e-5 and every gradient leaf of one step
    (``loss_fn`` under autograd, the RG-LRU's doubling scan and the
    mLSTM's chunkwise core included) against the reference's
    ``jax.grad``, relative to the leaf's norm, within ``GRAD_RTOL``
    (weights, gate biases)."""
    jc, pc, jp, pp = models(arch)
    rng = np.random.default_rng(10)
    b = {"tokens": rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32),
         "labels": rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTR.loss_fn(p, jc, {k: jnp.asarray(v)
                                      for k, v in b.items()}),
        has_aux=True))(jp)
    pm, pg = PTR._grads(pp, pc, PTR.to_device(b, "cpu"), False)
    assert float(pm["loss"]) == pytest.approx(float(jl), rel=1e-5)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(pg, pc))[0])
    assert len(got) == len(want)
    rtol_w, rtol_b = GRAD_RTOL[arch]
    for path, g in want:
        g = np.asarray(g)
        err = np.linalg.norm(got[path] - g) / max(np.linalg.norm(g), 1e-30)
        bias = getattr(path[-1], "key", None) in ("bi", "bf")
        assert err <= (rtol_b if bias else rtol_w), \
            (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", Z.REC)
def test_recurrent_state_bytes_match(arch):
    """At the published sizes: xlstm-1.3b carries 168.4 MB a row (40
    mLSTM layers x 4.20 MB + 8 sLSTM layers x 32 KB), recurrentgemma-9b
    1.06 MB."""
    got = PCM.recurrent_state_bytes(pget(arch))
    assert got == JCM.recurrent_state_bytes(jget(arch))
    assert got == {"xlstm-1.3b": 168_362_624,
                   "recurrentgemma-9b": 1_064_960}[arch]


# ----------------------------------------------------------------------
# head_dim 256 (recurrentgemma's attention: 16 query heads over 1 KV head)
def test_kernel_scopes_take_head_dim_256():
    """The wrappers' mirrors of the kernels' dispatch: bfloat16 head_dim
    256 at MQA 16 is in flash's ``wgmma`` scope and in the ragged kernel's
    tensor-core scope (pages of 16; its page ring fits shared memory),
    float32 in neither."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ragged_attention as RA
    mk = lambda shape: torch.zeros(shape, dtype=torch.bfloat16)
    q, k = mk((1, 16, 64, 256)), mk((1, 1, 64, 256))
    assert FA.wgmma_scope(q, k, k, torch.empty_like(q))
    assert not FA.wgmma_scope(q.float(), k.float(), k.float(), q.float())
    kp, ppos = mk((8, 16, 1, 256)), torch.zeros((8, 16), dtype=torch.int32)
    assert RA.mma_scope(mk((4, 1, 16, 256)), kp, ppos) is None
    assert RA.mma_scope(mk((4, 1, 16, 256)).float(), kp.float(), ppos) is not None
    assert RA._mma_smem(16, 256, RA.mma_tiles(1, 16)[2]) <= RA._SMEM_LIMIT


def test_plain_attention_at_head_dim_256_matches_pallas():
    """The plain versions the card's kernels are held to, at head_dim 256
    and MQA 16, against the reference's Pallas kernels in interpret mode:
    flash (a windowed causal chunk at an offset) and ragged paged
    attention (decode rows and a 4-token chunk, window 20, pages of 16)."""
    from repro.kernels import ragged_attention as JRA
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro_torch.kernels import ops
    from repro_torch.kernels import ragged_attention as PRA
    rng = np.random.default_rng(256)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = torch.from_numpy
    q, k, v = n(16, 64, 256), n(1, 256, 256), n(1, 256, 256)
    kw = dict(causal=True, window=100, q_offset=192)
    want = np.asarray(flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), bq=64, interpret=True, **kw))
    got = ops.flash_attention(t(q), t(k), t(v), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    ps, T = 16, 4
    for C in (1, 4):
        lens = np.array([C + 30, 0, C + 3])
        n_pages = sum(-(-x // ps) for x in lens) + 2
        ids = list(rng.permutation(n_pages))
        pages = np.full((3, T), -1, np.int32)
        ppos = np.full((n_pages, ps), -1, np.int32)
        for b, x in enumerate(lens):
            for o in range(-(-x // ps)):
                pages[b, o] = pid = ids.pop()
                for j in range(min(ps, x - o * ps)):
                    ppos[pid, j] = o * ps + j
        kp, vp = n(n_pages, ps, 1, 256), n(n_pages, ps, 1, 256)
        qq = n(3, C, 16, 256)
        qpos = (np.maximum(lens, C)[:, None] - C + np.arange(C)).astype(np.int32)
        wl = PRA.build_page_worklist(pages, lens, qpos[:, 0], qpos[:, -1], ps,
                                     window=20, pad_to=16)
        j = jnp.asarray
        pallas = np.asarray(JRA.ragged_attention_pallas(
            j(qq), j(kp), j(vp), j(ppos), j(qpos), *map(j, wl), window=20,
            interpret=True))
        got = PRA.ragged_attention(t(qq), t(kp), t(vp), t(ppos), t(pages),
                                   t(qpos), window=20).numpy()
        busy = lens > 0
        np.testing.assert_allclose(got[busy], pallas[busy], rtol=0, atol=2e-5)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inactive_rows_keep_their_carry(models, paged):
    """The reference's ``_gate_rows``: a step over rows [0, 2] of three
    leaves row 1's recurrent carry bit for bit (the ring and pages aside)
    and gives rows 0 and 2 what the ungated step gives them; a row chunk
    (``row=1``, pages) writes row 1's carry alone."""
    _, pc, _, pp = models("recurrentgemma-9b")
    kw = dict(kv_pages=8, kv_page=16, kv_max_pages=4) if paged else {}
    state = PT.init_decode_state(pc, 3, 32, "cpu", **kw)
    gen = torch.Generator().manual_seed(3)
    for blk in state["layers"]:
        for t in blk.get("rec", {}).values():
            t.copy_(torch.randn(t.shape, generator=gen))
    state["pos"] = np.array([4, 9, 2], np.int32)
    if paged:
        state["pages"][:, 0] = [0, 1, 2]
    rec = lambda st: [{k: v.clone() for k, v in blk["rec"].items()}
                      for blk in st["layers"] if "rec" in blk]
    before = rec(state)
    toks = np.array([[5], [6], [7]], np.int32)
    with torch.no_grad():
        _, full = PT.decode_step(pp, pc, dict(state, layers=[
            {k: {n: t.clone() for n, t in v.items()} for k, v in b.items()}
            for b in state["layers"]]), torch.as_tensor(toks))
        _, gated = PT.decode_step(pp, pc, state, torch.as_tensor(toks),
                                  active=np.array([True, False, True]))
    for b0, f, g in zip(before, rec(full), rec(gated)):
        for k in b0:
            assert torch.equal(g[k][1], b0[k][1]), k
            assert torch.equal(g[k][[0, 2]], f[k][[0, 2]]), k
    if paged:
        before = rec(gated)
        with torch.no_grad():
            _, chunk = PT.decode_step(pp, pc, gated,
                                      torch.tensor([[6, 8, 9]]), row=1)
        for b0, c in zip(before, rec(chunk)):
            for k in b0:
                assert torch.equal(c[k][[0, 2]], b0[k][[0, 2]]), k
                assert not torch.equal(c[k][1], b0[k][1]), k
