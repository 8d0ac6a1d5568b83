"""The port's attention-only config zoo against the JAX reference, on the
CPU, at ``reduced()`` sizes (and the narrow configs of
``tests/zoo_models.py``): the model, its parameters and its training.

* Configs: the six zoo names are served with the reference's fields, and
  so are the recurrent two and whisper (ported by later slices);
  ``ASSIGNED_ARCHS``, ``SWA_FOR_LONG`` and ``config_for_shape`` are the
  reference's.
* ``count_params_analytic`` equals the reference's at the published
  sizes, and ``param_specs`` gives the shapes ``init_model`` makes.
* ``forward_train`` logits within atol 1e-4 of the reference's (float32,
  the same products summed in another order), phi-3 with its image
  embeddings; one train step's loss, ce and gradient norm within 1e-5
  relative (grad norm 1e-4), and two microbatches on
  ``command-r-plus-104b``.
* ``generate_plain`` tokens exactly equal.
* Tail layers: ``forward_train`` (also with ``remat``) and
  ``quantize_for_offload``'s ``size_report`` byte for byte, packed and
  not; the bridge round trip.  Head_dim 96 (phi-3, 2 heads x 96):
  logits and tokens.  The softcap: logits equal, and a pad id's logit is
  -softcap, not -inf, as in the reference (ROADMAP section 3).

The reference's runs are shared through module-scoped fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_models as Z
from repro import configs as JC
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import generate_plain as jgenerate
from repro.core.offload_engine import quantize_for_offload as jquantize
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core.offload_engine import generate_plain as pgenerate
from repro_torch.core.offload_engine import quantize_for_offload as pquantize
from repro_torch.models import transformer as PT
from repro_torch.quant.hqq import tree_leaves, tree_map
from repro_torch.training import optimizer as PO
from repro_torch.training import trainer as PTR

LOGIT_ATOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
RTOL = {"loss": 1e-5, "ce": 1e-5, "grad_norm": 1e-4}


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


def _forward(models, name, *, images=False, remat=False):
    jc, pc, jp, pp = models(name)
    toks = Z.tokens(jc, 2, 24)
    jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if images:
        img = Z.image_embeds(jc, 2)
        jb["image_embeds"], pb["image_embeds"] = jnp.asarray(img), img
    want, _ = JT.forward_train(jp, jc, jb)
    with torch.no_grad():
        got, _ = PT.forward_train(pp, pc, pb, remat=remat)
    return np.asarray(want), got.numpy()


# ----------------------------------------------------------------------
# configs
@pytest.mark.parametrize("arch", Z.ZOO)
def test_zoo_config_fields_match(arch):
    """Every field of the port's config is the reference's, at the
    published size and reduced, and the SWA variant of long_500k too."""
    for shape in ("train_4k", "long_500k"):
        j, p = JC.config_for_shape(arch, shape), PC.config_for_shape(arch, shape)
        for want, got in ((j, p), (j.reduced(), p.reduced())):
            for f in dataclasses.fields(got):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if dataclasses.is_dataclass(a):  # MoESpec, OffloadSpec
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, f.name
            assert got.n_tail_layers == want.n_tail_layers
            assert got.padded_vocab == want.padded_vocab


def test_registry_matches_reference():
    assert PC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert PC.SWA_FOR_LONG == JC.SWA_FOR_LONG
    assert PC.list_archs() == JC.list_archs()


@pytest.mark.parametrize("arch,item", [("recurrentgemma-9b", "sub-item 3"),
                                       ("xlstm-1.3b", "sub-item 3"),
                                       ("whisper-medium", "sub-item 4")])
def test_unported_zoo_names_are_refused(arch, item):
    """The names ROADMAP item 6's sub-items 3 (the recurrent mixers) and 4
    (the encoder-decoder) ported, once refused here, give the reference's
    configs, field by field, with its state planes and derived flags."""
    got, want = PC.get_config(arch), JC.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.state_planes() == tuple(
        type(got.state_planes()[0])(**dataclasses.asdict(sp))
        for sp in want.state_planes())
    assert (got.has_kv_layers, got.has_recurrent_layers,
            got.is_encoder_decoder, got.attention_only_stack) == \
        (want.has_kv_layers, want.has_recurrent_layers,
         want.is_encoder_decoder, want.attention_only_stack)


@pytest.mark.parametrize("arch", Z.ZOO + Z.REC)
def test_zoo_count_params_analytic_matches(arch):
    """At the published size (shapes only), and at the reduced size
    against the leaves ``init_model`` makes (the recurrent configs' too:
    no ``attn`` in a recurrent block, no ``norm2`` without an FFN)."""
    assert PT.count_params_analytic(PC.get_config(arch)) == \
        JT.count_params_analytic(JC.get_config(arch))
    cfg = PC.get_config(arch).reduced()
    params = PT.init_model(cfg, device="cpu")
    assert sum(a.numel() for a in tree_leaves(params)) == \
        JT.count_params_analytic(JC.get_config(arch).reduced())
    specs = PT.param_specs(cfg)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert jax.tree.map(lambda s: s[0], specs,
                        is_leaf=lambda s: isinstance(s, tuple)) == shapes(params)


# ----------------------------------------------------------------------
# the model
@pytest.mark.parametrize("arch", Z.ZOO)
def test_zoo_forward_train_matches(models, arch):
    want, got = _forward(models, arch, images=arch.startswith("phi-3"))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_image_stub_matches(models):
    """phi-3's image-token stub: the first ``num_image_tokens`` positions
    come from ``image_embeds`` through ``img_proj``, and every position
    (they attend to those) differs from the text-only forward."""
    want, got = _forward(models, "phi-3-vision-4.2b", images=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    _, text = _forward(models, "phi-3-vision-4.2b")
    assert (np.abs(got - text).max(-1) > 1e-3).all()


def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}


@pytest.mark.parametrize("arch,micro", [(a, 1) for a in Z.ZOO]
                         + [("command-r-plus-104b", 2)])
def test_zoo_train_step_matches(models, arch, micro):
    jc, pc, jp, pp = models(arch)
    jstep = JTR.make_train_step(jc, JO.OptimizerConfig(**OPT),
                                microbatches=micro, remat=micro > 1)
    pstep = PTR.make_train_step(pc, PO.OptimizerConfig(**OPT),
                                microbatches=micro, remat=micro > 1)
    b = _train_batch(jc, seed=10)
    _, _, jm = jax.jit(jstep)(jp, JO.init_opt_state(jp),
                              {k: jnp.asarray(v) for k, v in b.items()})
    _, _, pm = pstep(pp, PO.init_opt_state(pp), PTR.to_device(b, "cpu"))
    for k, rel in RTOL.items():
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=rel), k


def test_only_img_proj_may_go_unreached(models):
    """Without ``image_embeds`` phi-3's ``img_proj`` gets a zero gradient,
    as under ``jax.grad``; any other leaf the loss does not reach (a leaf
    cut off by a fault) still raises."""
    _, pc, _, pp = models("phi-3-vision-4.2b")
    b = PTR.to_device(_train_batch(pc, seed=10), "cpu")
    _, grads = PTR._grads(pp, pc, b, False)
    assert not grads["img_proj"].any() and list(grads) == list(pp)
    with pytest.raises(RuntimeError, match="not have been used"):
        PTR._grads({**pp, "orphan": torch.ones(3)}, pc, b, False)


@pytest.mark.parametrize("arch", Z.ZOO)
def test_zoo_generate_plain_matches(models, arch):
    jc, pc, jp, pp = models(arch)
    prompt = Z.tokens(jc, 1, 9)
    want = np.asarray(jgenerate(jp, jc, prompt, 6))
    assert pgenerate(pp, pc, prompt, 6, device="cpu").tolist() == want.tolist()


# ----------------------------------------------------------------------
# the features no zoo config reaches at its reduced size
def test_head_dim_96_matches(models):
    """phi-3 at its published head_dim 96 (2 heads x 96, the flash and
    ragged kernels' new instance on the card): logits and tokens."""
    want, got = _forward(models, "phi3-hd96", images=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    jc, pc, jp, pp = models("phi3-hd96")
    prompt = Z.tokens(jc, 1, 9)
    assert pgenerate(pp, pc, prompt, 6, device="cpu").tolist() == \
        np.asarray(jgenerate(jp, jc, prompt, 6)).tolist()


@pytest.mark.parametrize("remat", [False, True])
def test_tail_layers_forward_matches(models, remat):
    """3 layers of a 2-layer pattern: the reference's unstacked ``tail``
    block runs after the period, outside the checkpointed periods."""
    jc, pc, _, pp = models("tail")
    assert jc.n_tail_layers == pc.n_tail_layers == 1
    want, got = _forward(models, "tail", remat=remat)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    if remat:  # gradients through the rematted period and the tail
        b = PTR.to_device(_train_batch(jc, seed=3), "cpu")
        leaf = lambda t: t.detach().clone().requires_grad_(
            t.is_floating_point())
        grads = []
        for r in (False, True):
            ps = tree_map(leaf, pp)
            grads.append(torch.autograd.grad(
                PTR.loss_fn(ps, pc, b, remat=r)[0],
                [ps["layers"][l]["attn"]["wq"] for l in range(3)]))
        for a, c in zip(*grads):
            torch.testing.assert_close(a, c, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pack", [False, True])
def test_tail_layers_size_report_matches(models, pack):
    """``quantize_for_offload``: a tail layer's leaves are quantized one
    by one in their own shape (the tail's ``wq`` as (D, H * hd), where the
    period-stacked ``wq`` stays 16-bit), so the byte counts equal the
    reference's exactly.  The dequantized tail ``wq`` is within 1e-3 of
    the reference's in norm (HQQ's zero-point iteration is a float
    optimisation: a group's scale and zero may settle slightly apart,
    ``test_torch_hqq.py``) and not the unquantized weight."""
    jc, pc, jp, pp = models("tail")
    spec = jc.offload
    jout = jquantize(jp, jc, spec, pack_experts=pack)
    pout = pquantize(pp, pc, PSpec(**dataclasses.asdict(spec)),
                     pack_experts=pack, device="cpu")
    assert pout[1] == jout[1]
    tail_j = jout[0]["tail"][0]["attn"]["wq"]
    tail_p = pout[0]["layers"][2]["attn"]["wq"]
    tail_p, tail_j = tail_p.numpy(), np.asarray(tail_j)
    assert np.linalg.norm(tail_p - tail_j) <= 1e-3 * np.linalg.norm(tail_j)
    assert not np.array_equal(np.asarray(tail_j),
                              np.asarray(jp["tail"][0]["attn"]["wq"]))


def test_bridge_round_trip_with_tail(models):
    jc, pc, jp, pp = models("tail")
    tree = bridge.params_to_numpy(pp, pc)
    want = jax.tree.map(np.asarray, jp)
    assert len(tree["tail"]) == 1
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_softcap_matches_and_caps_pad_ids(models):
    """The softcap after the pad mask, as in the reference: logits equal,
    within the cap, and every pad id's logit is -softcap (the reference's
    trait: tanh(-1e30 / c) = -1), not -inf."""
    jc, pc, _, _ = models("softcap")
    want, got = _forward(models, "softcap")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    c = pc.logit_softcap
    assert pc.padded_vocab > pc.vocab_size
    np.testing.assert_array_equal(got[..., pc.vocab_size:], -c)
    np.testing.assert_array_equal(want[..., jc.vocab_size:], -c)
    assert np.abs(got[..., :pc.vocab_size]).max() < c


def test_kernel_scopes_take_head_dim_96():
    """The wrappers' mirrors of the kernels' dispatch: bfloat16 head_dim
    96 is in the flash kernel's ``wgmma`` scope and the ragged kernel's
    tensor-core scope (pages of 16)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ragged_attention as RA
    mk = lambda shape: torch.zeros(shape, dtype=torch.bfloat16)
    q, k = mk((1, 32, 64, 96)), mk((1, 32, 64, 96))
    assert FA.wgmma_scope(q, k, k, torch.empty_like(q))
    assert not FA.wgmma_scope(q.float(), k.float(), k.float(), q.float())
    kp, ppos = mk((8, 16, 32, 96)), torch.zeros((8, 16), dtype=torch.int32)
    assert RA.mma_scope(mk((4, 1, 32, 96)), kp, ppos) is None
    assert RA.mma_scope(mk((4, 1, 32, 96)).float(), kp.float(), ppos) is not None


def test_launcher_refuses_what_does_not_fit(monkeypatch):
    """On the card a model whose resident weights exceed the free memory
    is refused with the bytes it needs and the bytes free: the 64-layer
    ``command-r-plus-104b`` needs ~208 GB in bf16; packed granite keeps
    only its non-expert weights resident."""
    from repro_torch.core import cost_model as CM
    cfg = PC.get_config("command-r-plus-104b")
    need = CM.resident_bytes(cfg, packed=False)
    assert need == PT.count_params_analytic(cfg) * 2 > 200e9
    g = PC.get_config("granite-moe-1b-a400m")
    experts = g.moe_layer_count * g.moe.num_experts * 3 * g.d_model * g.d_ff
    assert CM.resident_bytes(g, packed=True) == \
        (PT.count_params_analytic(g) - experts) * 2
    assert CM.resident_bytes(g, training=True) == PT.count_params_analytic(g) * 12
    CM.check_fits(need, "cpu run", torch.device("cpu"))  # the CPU: no check
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (80e9, 85e9))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    with pytest.raises(SystemExit, match=r"needs 207\.6 GB .* card has 80\.0 GB free"):
        CM.check_fits(need, cfg.name, torch.device("cuda", 0))
    CM.check_fits(70e9, "a smaller model", torch.device("cuda", 0))
