"""The port's encoder-decoder (``whisper-medium``) against the JAX
reference, on the CPU, at ``reduced()`` size in float32 (2 decoder + 2
encoder layers, d_model 256, 4 / 4 heads x 64, 24 frames).

* The config field by field, published and reduced, and
  ``count_params_analytic`` at both sizes; the bridge round trip
  (encoder stack, ``norm_x`` / ``xattn`` included).
* ``encode_enc_kv`` (and ``Executor.encode``) within 1e-5 of the
  reference's; ``forward_train`` logits with ``audio_embeds`` within
  1e-4, and its decode state's encoder-KV plane; one train step's loss
  and every gradient leaf, the encoder's included, within 1e-5 relative.
* ``generate_plain`` tokens equal the reference's; ``prefill(extras=)``
  in chunks against whole; the missing-audio errors.
* ``ContinuousEngine`` on ``dense``, ``dense_chunked`` and ``paged``, and
  draft-and-verify with ``tiny-draft`` on dense slots and on pages: each
  request's tokens equal the reference's B = 1 ``generate_plain`` stream
  (``parity.oracle_streams``, with ``parity.make_extras``' frontends).
* ``submit``'s audio checks, the prefix-cache and preemption refusals,
  the packed offload engine's refusal (whisper has no experts) and the
  static engine's, as the reference's.
* ``kv_read_bytes_per_token``, ``admission_cost().enc_kv_bytes`` and the
  roofline's ``enc_kv_read_bytes_per_token`` equal the reference's.
* The plain flash version at ``causal=False`` (encoder self-attention,
  cross-attention at decode and over a chunk) against the reference's
  Pallas kernel in interpret mode.

Parameters are the reference-layout numpy draws of ``tests/zoo_models.py``;
the reference's runs are shared through module-scoped fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
import zoo_models as Z
from repro.configs import get_config as jget
from repro.core import cost_model as JCM
from repro.core.offload_engine import OffloadEngine as JOffload
from repro.core.offload_engine import generate_plain as jgenerate
from repro.models import transformer as JT
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.obs.roofline import RooflineAccountant as JRoofline
from repro.serving.engine import ContinuousEngine as JContinuous
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServe
from repro.serving.scheduler import admission_cost as jadmission
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.core import cost_model as PCM
from repro_torch.core.offload_engine import OffloadEngine as POffload
from repro_torch.core.offload_engine import generate_plain as pgenerate
from repro_torch.models import transformer as PT
from repro_torch.obs.registry import MetricsRegistry as PRegistry
from repro_torch.obs.roofline import RooflineAccountant as PRoofline
from repro_torch.runtime.executor import Executor as PExecutor
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.engine import Request as PRequest
from repro_torch.serving.engine import ServeEngine as PServe
from repro_torch.serving.scheduler import admission_cost as padmission
from repro_torch.training import trainer as PTR

ARCH = "whisper-medium"
LENS = (5, 9, 11)
MAX_NEWS = (6, 5, 4)
LOGIT_ATOL = 1e-4
ENC_ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(reference config, port config, reference params, port params)."""
    return Z.Models()(ARCH)


def _audio(cfg, B, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def oracle(model):
    """(prompts, per-request extras, the reference's B = 1 streams)."""
    jc, _, jp, _ = model
    prompts = parity.make_prompts(jc, LENS)
    extras = parity.make_extras(jc, len(prompts))
    return prompts, extras, parity.oracle_streams(jp, jc, prompts,
                                                  list(MAX_NEWS), extras)


def _serve(pp, pc, prompts, extras, **kw):
    eng = PContinuous(pp, pc, max_slots=2, slot_len=64, eos_id=None,
                      device="cpu", **kw)
    reqs = [eng.submit(p, m, extras=e)
            for p, m, e in zip(prompts, MAX_NEWS, extras)]
    eng.run(max_steps=400)
    assert all(r.state == "finished" for r in reqs)
    return [r.generated for r in reqs], eng


# ----------------------------------------------------------------------
# config, parameters
def test_config_and_param_count_match():
    for want, got in ((jget(ARCH), pget(ARCH)),
                      (jget(ARCH).reduced(), pget(ARCH).reduced())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.is_encoder_decoder and not got.attention_only_stack
        assert PT.count_params_analytic(got) == JT.count_params_analytic(want)
    cfg = pget(ARCH).reduced()
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.encoder_seq, cfg.dtype) == \
        (2, 2, 256, 4, 4, 64, 24, "float32")
    params = PT.init_model(cfg, device="cpu")
    leaves = jax.tree.leaves(params)
    assert sum(a.numel() for a in leaves) == PT.count_params_analytic(cfg)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(params) == jax.tree.map(
        lambda s: s[0], PT.param_specs(cfg),
        is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))


def test_bridge_round_trip(model):
    jc, pc, jp, pp = model
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jp))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(pp, pc))[0])
    assert len(got) == len(want)
    for path, a in want:
        np.testing.assert_array_equal(got[path], a, jax.tree_util.keystr(path))
    assert len(pp["encoder"]["layers"]) == jc.encoder_layers
    assert {"norm_x", "xattn"} <= set(pp["layers"][0])


# ----------------------------------------------------------------------
# the encoder, the forward, training
@pytest.fixture(scope="module")
def ref_forward(model):
    """The reference's encoder-KV plane and forward of a 2-row batch."""
    jc, _, jp, _ = model
    audio, toks = _audio(jc, 2), Z.tokens(jc, 2, 12)
    enc = JT.encode_enc_kv(jp, jc, jnp.asarray(audio))
    logits, _, state = JT.forward_train(
        jp, jc, {"tokens": jnp.asarray(toks),
                 "audio_embeds": jnp.asarray(audio)}, want_state=True,
        max_len=16)
    return audio, toks, enc, np.asarray(logits), state


def test_encode_enc_kv_matches_reference(model, ref_forward):
    jc, pc, _, pp = model
    audio, _, want, _, _ = ref_forward
    with torch.no_grad():
        got = PT.encode_enc_kv(pp, pc, audio)
    ex = PExecutor(pp, pc, device="cpu").encode(audio)
    ref = bridge.enc_kv_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    for k in ("k", "v"):
        assert got[k].shape == (jc.n_layers, 2, jc.encoder_seq,
                                jc.n_kv_heads, jc.head_dim)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=ENC_ATOL, err_msg=k)
        assert torch.equal(ex[k], got[k])
    assert (np.asarray(want["pos"]) == np.arange(jc.encoder_seq)).all()


def test_forward_train_matches_reference(model, ref_forward):
    """Logits with ``audio_embeds``, the static prefill's encoder-KV plane
    and self-attention rings; no audio is refused."""
    jc, pc, _, pp = model
    audio, toks, _, want, jstate = ref_forward
    with torch.no_grad():
        got, _, state = PT.forward_train(
            pp, pc, {"tokens": torch.as_tensor(toks), "audio_embeds": audio},
            want_state=True, max_len=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(state["enc_kv"][k].numpy(),
                                   np.asarray(jstate["enc_kv"][k]), rtol=0,
                                   atol=ENC_ATOL)
        for l, blk in enumerate(state["layers"]):
            np.testing.assert_allclose(
                blk["kv"][k].numpy(),
                np.asarray(jstate["stack"][0]["kv"][k][l]), rtol=0,
                atol=ENC_ATOL)
    with pytest.raises(ValueError, match="audio_embeds"):
        PT.forward_train(pp, pc, {"tokens": torch.as_tensor(toks)})


def test_train_step_gradients_match(model):
    """The loss within 1e-5 and every gradient leaf of one step (the
    encoder's, ``norm_x`` and ``xattn`` included) against the
    reference's ``jax.grad``, relative to the leaf's norm."""
    jc, pc, jp, pp = model
    rng = np.random.default_rng(10)
    b = {"tokens": rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32),
         "labels": rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32),
         "audio_embeds": _audio(jc, 2, seed=11)}
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
    assert any("encoder" in jax.tree_util.keystr(p) for p, _ in want)
    for path, g in want:
        g, name = np.asarray(g), jax.tree_util.keystr(path)
        if name.endswith("['xattn']['bk']"):
            # a key bias shared by every key shifts each query's scores
            # alike (no RoPE on cross-attention): its true gradient is 0,
            # and both sides hold rounding noise (~1e-8)
            assert max(np.linalg.norm(g), np.linalg.norm(got[path])) < 1e-6
            continue
        err = np.linalg.norm(got[path] - g) / max(np.linalg.norm(g), 1e-30)
        assert err <= GRAD_RTOL, (name, err)


# ----------------------------------------------------------------------
# generation and serving
def test_generate_plain_and_chunked_prefill(model, oracle):
    jc, pc, jp, pp = model
    prompts, extras, want = oracle
    one = {"audio_embeds": extras[1]["audio_embeds"][None]}
    got = pgenerate(pp, pc, prompts[1][None], MAX_NEWS[1], extras=one,
                    device="cpu")
    assert got[0].tolist() == want[1]
    ex = PExecutor(pp, pc, device="cpu")
    with torch.no_grad():
        whole, ws = ex.prefill(prompts[2][None], 16, extras=one)
        for c in (1, 3, 4):
            part, s = ex.prefill(prompts[2][None], 16, chunk=c, extras=one)
            np.testing.assert_allclose(part[:, -1].numpy(),
                                       whole[:, -1].numpy(), rtol=0,
                                       atol=LOGIT_ATOL, err_msg=f"chunk {c}")
            assert int(s["pos"]) == int(ws["pos"]) == len(prompts[2])
    with pytest.raises(ValueError, match="prefill needs"):
        ex.prefill(prompts[0][None], 16)
    from repro.runtime.executor import Executor as JExecutor
    with pytest.raises(ValueError, match="prefill needs"):
        JExecutor(jp, jc).prefill(prompts[0][None], 16)


@pytest.mark.parametrize("variant", ["dense", "dense_chunked", "paged"])
def test_continuous_matches_oracle(model, oracle, variant):
    _, pc, _, pp = model
    prompts, extras, want = oracle
    got, eng = _serve(pp, pc, prompts, extras,
                      **parity.CONTINUOUS_KV_VARIANTS[variant])
    parity.assert_tokens_equal(got, want, f"{ARCH}/{variant}")
    assert eng.sched.joins == len(prompts) > eng.max_slots
    eng.kv.check_invariants()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_draft_and_verify_matches_oracle(model, oracle, layout):
    """Draft-and-verify with a random ``tiny-draft`` (k = 2): whisper has
    no recurrent carry, so it runs on pages as well as on dense slots."""
    _, pc, _, pp = model
    prompts, extras, want = oracle
    dcfg = pget("tiny-draft")
    got, eng = _serve(pp, pc, prompts, extras,
                      kv_page=16 if layout == "paged" else None,
                      draft_params=PT.init_model(dcfg, seed=1, device="cpu"),
                      draft_cfg=dcfg, num_draft_tokens=2)
    parity.assert_tokens_equal(got, want, f"{ARCH}/draft/{layout}")
    assert eng.obs.snapshot()["spec"]["rounds"] > 0


def test_refusals_match_reference(model):
    """``submit`` without audio or with the wrong frame count, prefix
    caching and preemption, the packed offload engine (no experts) and the
    static engine (no audio input: the reference fails with a KeyError,
    the port names the missing input)."""
    jc, pc, jp, pp = model
    prompt = np.arange(1, 6, dtype=np.int32)
    bad = {"audio_embeds": np.zeros((jc.encoder_seq + 1, jc.d_model),
                                    np.float32)}
    engines = (JContinuous(jp, jc, max_slots=2, slot_len=64, eos_id=None),
               PContinuous(pp, pc, max_slots=2, slot_len=64, eos_id=None,
                           device="cpu"))
    for eng in engines:
        with pytest.raises(ValueError, match="submit\\(\\) needs extras"):
            eng.submit(prompt, 4)
        with pytest.raises(ValueError, match="audio_embeds must be"):
            eng.submit(prompt, 4, extras=bad)
    for ctor, p, c, kw in ((JContinuous, jp, jc, {}),
                           (PContinuous, pp, pc, dict(device="cpu"))):
        for flag in (dict(prefix_cache_pages=4), dict(preemption=True)):
            with pytest.raises(ValueError, match="causal-attention stack"):
                ctor(p, c, max_slots=2, slot_len=64, kv_page=16, **flag,
                     **kw)
    for ctor, p, c, kw in ((JOffload, jp, jc, {}),
                           (POffload, pp, pc, dict(device="cpu"))):
        with pytest.raises(AssertionError, match="MoE"):
            ctor(p, c, c.offload, **kw)
    reqs = lambda R: [R(np.arange(1, 6, dtype=np.int32), 3)] * 2
    with pytest.raises(KeyError, match="audio_embeds"):
        JServe(jp, jc).serve_batch(reqs(JRequest))
    with pytest.raises(ValueError, match="audio_embeds"):
        PServe(pp, pc, device="cpu").serve_batch(reqs(PRequest))


# ----------------------------------------------------------------------
def test_cost_terms_match_reference():
    for name in (ARCH, "tiny-moe"):
        for jc, pc in ((jget(name), pget(name)),
                       (jget(name).reduced(), pget(name).reduced())):
            for ctx in (0, 64, 1000):
                assert PCM.kv_read_bytes_per_token(pc, ctx) == \
                    JCM.kv_read_bytes_per_token(jc, ctx)
            assert dataclasses.asdict(padmission(pc, 10, 20)) == \
                dataclasses.asdict(jadmission(jc, 10, 20))
            gauge = lambda r: r.snapshot()["roofline"][
                "enc_kv_read_bytes_per_token"]
            jr, pr = JRegistry(), PRegistry()
            JRoofline(jr, jc)
            PRoofline(pr, pc)
            assert gauge(pr) == gauge(jr)
    cfg = pget(ARCH)  # 24 layers x 1500 frames x 16 x 64 x K, V in bf16
    assert padmission(cfg, 10, 20).enc_kv_bytes == 147_456_000


@pytest.mark.parametrize("Sq", [1, 8, 24])
def test_plain_flash_non_causal_matches_pallas(Sq):
    """The plain version the card's kernel is held to at whisper's
    non-causal shapes (hd 64, 4 / 4 heads, 24 keys): cross-attention at
    decode (1 query), over a chunk (8), and the encoder (24 x 24)."""
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro_torch.kernels import ops
    rng = np.random.default_rng(Sq)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = n(4, Sq, 64), n(4, 24, 64), n(4, 24, 64)
    want = np.asarray(flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), causal=False, interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * float(np.abs(want).max()))
