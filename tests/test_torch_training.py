"""The port's training stack against the JAX reference's, on the CPU, with
the same seeded weights crossed over by ``repro_torch.bridge`` and the
same numpy batches.

* Data: the corpus, the train and eval batches and the byte codec are
  byte for byte the reference's.
* Optimizer: ``schedule`` within 1e-6 relative (float32 on both sides);
  ``apply_updates`` over three steps on a random tree, with and without
  clipping and with bfloat16 moments: gradient norm and learning rate
  within 1e-6 relative; parameters within 1e-6 absolute and float32
  moments within 1e-5 relative (the same float32 operations, a few in
  another order); bfloat16 moments within 2^-7 relative (one bfloat16
  rounding of float32 values that may differ in their last bit).
* MoE: ``capacity`` exactly; ``aux_losses`` within 1e-6; the dispatch
  plan (which token sits in which expert slot, its weight, what is
  dropped) exactly equal to the reference's, read back through an expert
  function that returns each slot's one-hot code; ``moe_apply_dispatch``
  outputs within 1e-5 with drops, groups and pad masks.
* Attention: ``attention_train`` at S = 1024 (two query chunks), global
  and windowed, within 1e-5; its gradient through the recomputed chunks
  equal to the unchunked one within 1e-6.
* Model: ``forward_train`` logits within 1e-4 and load balance within
  1e-5, with and without ``remat`` and with a left-pad mask; every
  leaf's gradient of ``loss_fn`` within 1e-4 of the leaf's largest
  reference gradient.
* Training: four steps of ``make_train_step`` (one and two microbatches)
  and three of ``train``: loss, ce and load balance per step within 1e-5
  relative (measured: under 4e-7), the gradient norm within 1e-4
  relative and the parameters after the steps within 1e-4 absolute
  (lr 1e-3).  Adam moves each entry by about lr * g / |g|, so where a
  gradient entry is near ``eps`` (1e-8) its round-off moves the step by
  up to lr: the parameters part by up to 9e-6 after one step and 3.5e-5
  after four (measured), and the gradient norm, taken at those
  parameters, by 2.5e-5 relative; ``eval_ce`` within 1e-5.
* Checkpoints read in both directions, bit for bit; a shape mismatch
  raises.  ``count_params_analytic`` equal for every ported config.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JC
from repro.configs import get_config as jget
from repro.data import pipeline as JD
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch.checkpoint import checkpointer as PC
from repro_torch.configs import get_config as pget
from repro_torch.data import pipeline as PD
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.quant.hqq import tree_leaves
from repro_torch.training import optimizer as PO
from repro_torch.training import trainer as PTR

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors.  Under the xdist
    workers the cores are shared, and a multi-threaded OpenMP region then
    waits at its barrier for threads that are descheduled (on an 8-core
    host, a test of 0.25 s alone took 90 s beside five busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(params, cfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                    "cpu")


def leaf_pairs(jtree, ptree, cfg):
    """(path, reference leaf, port leaf) over the reference's layout."""
    pn = bridge.params_to_numpy(ptree, cfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = pn
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(**SMALL)
    pcfg = pget("tiny-moe").replace(**SMALL)
    params = JT.init_model(jax.random.key(1), jcfg)
    return jcfg, pcfg, params, to_port(params, pcfg)


def batch(B=4, S=32, seed=0, vocab=259):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ----------------------------------------------------------------------
# data
def test_corpus_and_batches_are_the_references():
    jc = JD.build_corpus(max_bytes=300_000)
    pc = PD.build_corpus(max_bytes=300_000)
    assert pc.dtype == jc.dtype and pc.size == 300_000
    np.testing.assert_array_equal(pc, jc)
    cfg = dict(seq_len=64, batch_size=4, max_bytes=300_000, seed=3)
    jds = JD.PackedDataset(JD.DataConfig(**cfg), corpus=jc)
    pds = PD.PackedDataset(PD.DataConfig(**cfg), corpus=pc)
    for a, b in zip(itertools.islice(jds.batches(), 5),
                    itertools.islice(pds.batches(), 5)):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], a[k])
    je, pe = list(jds.eval_batches(3)), list(pds.eval_batches(3))
    assert len(pe) == len(je) == 3
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
        np.testing.assert_array_equal(b["labels"], a["labels"])
    text = "déjà vu\n\tdef f(): pass"
    np.testing.assert_array_equal(PD.encode_text(text), JD.encode_text(text))
    codes = np.concatenate([JD.encode_text(text), [PD.EOS, PD.PAD]])
    assert PD.decode_bytes(codes) == JD.decode_bytes(codes) == text


# ----------------------------------------------------------------------
# optimizer
def test_schedule_matches():
    cfg = dict(lr=1e-3, warmup_steps=30, total_steps=300, min_lr_frac=0.1)
    jc, pc = JO.OptimizerConfig(**cfg), PO.OptimizerConfig(**cfg)
    for step in (0, 1, 15, 29, 30, 31, 100, 299, 300, 450):
        want = float(JO.schedule(jc, step))
        assert PO.schedule(pc, step) == pytest.approx(want, rel=1e-6), step


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": a(8, 16), "b": a(16), "layers": [{"k": a(4, 4, 3)},
                                                  {"k": a(4, 4, 3)}]}


@pytest.mark.parametrize("clip,moments", [(1.0, "float32"), (100.0, "float32"),
                                          (1.0, "bfloat16")])
def test_apply_updates_matches(clip, moments):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
               weight_decay=0.1, moment_dtype=moments)
    jc, pc = JO.OptimizerConfig(**cfg), PO.OptimizerConfig(**cfg)
    params = _random_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    pp = jax.tree.map(torch.from_numpy, params)
    js, ps = JO.init_opt_state(jp, jc), PO.init_opt_state(pp, pc)
    for step in range(3):
        grads = jax.tree.map(lambda a: a * (0.5 + step), _random_tree(10 + step))
        jp, js, jm = JO.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, jc)
        pp, ps, pm = PO.apply_updates(pp, jax.tree.map(torch.from_numpy, grads), ps, pc)
        assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert ps["step"] == int(js["step"]) == step + 1
    if clip == 1.0:
        assert float(jm["grad_norm"]) > clip  # clipping was active
    for name in ("w", "b"):
        np.testing.assert_allclose(pp[name].numpy(), np.asarray(jp[name]),
                                   rtol=0, atol=1e-6)
        mrtol = 1e-5 if moments == "float32" else 2 ** -7
        for m in ("mu", "nu"):
            got, want = ps[m][name], js[m][name]
            assert str(got.dtype).endswith(moments)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), rtol=mrtol,
                                       atol=1e-12)
    np.testing.assert_allclose(pp["layers"][1]["k"].numpy(),
                               np.asarray(jp["layers"][1]["k"]), rtol=0, atol=1e-6)


def test_weight_decay_only_on_matrices():
    """A zero gradient moves only the >= 2-D leaves (decay), not vectors."""
    cfg = PO.OptimizerConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    params = jax.tree.map(torch.from_numpy, _random_tree(1))
    zeros = jax.tree.map(torch.zeros_like, params)
    new, _, _ = PO.apply_updates(params, zeros, PO.init_opt_state(params), cfg)
    assert torch.equal(new["b"], params["b"])
    assert not torch.equal(new["w"], params["w"])


# ----------------------------------------------------------------------
# MoE
@pytest.mark.parametrize("T,E,K,cf", [(1, 8, 2, 1.25), (32, 4, 2, 0.5),
                                      (100, 8, 2, 1.25), (1024, 8, 1, 2.0),
                                      (7, 3, 3, 1.0)])
def test_capacity_matches(T, E, K, cf):
    jspec = jget("tiny-moe").moe.__class__(num_experts=E, top_k=K,
                                           capacity_factor=cf)
    pspec = pget("tiny-moe").moe.__class__(num_experts=E, top_k=K,
                                           capacity_factor=cf)
    assert PM.capacity(pspec, T) == JM.capacity(jspec, T)


@pytest.mark.parametrize("masked", [False, True])
def test_aux_losses_match(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    mask = rng.random(40) > 0.3 if masked else None
    spec = pget("tiny-moe").moe
    want = JM.aux_losses(jget("tiny-moe").moe, jnp.asarray(probs),
                         jnp.asarray(ids),
                         None if mask is None else jnp.asarray(mask))
    got = PM.aux_losses(spec, torch.from_numpy(probs), torch.from_numpy(ids),
                        None if mask is None else torch.from_numpy(mask))
    assert float(got["load_balance"]) == pytest.approx(
        float(want["load_balance"]), rel=1e-6)


def _moe_case(E=4, D=128, T=32, seed=3):
    jcfg = jget("tiny-moe").replace(d_model=D, d_ff=32)
    jcfg = jcfg.replace(moe=jcfg.moe.__class__(num_experts=E, top_k=2))
    pcfg = pget("tiny-moe").replace(d_model=D, d_ff=32)
    pcfg = pcfg.replace(moe=pcfg.moe.__class__(num_experts=E, top_k=2))
    jp = JM.init_moe(jax.random.key(seed), jcfg)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), jp)
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    return jcfg, pcfg, jp, pp, x


DISPATCH_CASES = [(1.0, 1, False), (0.5, 1, False), (0.5, 2, False),
                  (0.5, 1, True), (0.5, 2, True), (4.0, 2, True)]


@pytest.mark.parametrize("cf,groups,masked", DISPATCH_CASES)
def test_dispatch_plan_matches_exactly(cf, groups, masked):
    """Each expert slot's token and weight, and so every drop, equal to
    the reference's.  The reference's plan is read back by running its
    dispatch with an expert function that writes slot (e, c)'s one-hot
    code e * C + c into the output row: the combine then leaves, in column
    e * C + c, the slot's weight in its token's row (nothing: empty)."""
    jcfg, pcfg, jp, pp, x = _moe_case()
    T, D, E, K = 32, 128, 4, 2
    spec = jcfg.moe.__class__(num_experts=E, top_k=K, capacity_factor=cf)
    Tg = T // groups
    C = JM.capacity(spec, Tg)
    assert E * C <= D
    mask = (np.arange(T) % 5 != 1) if masked else np.ones(T, bool)
    code = jnp.eye(E * C, D, dtype=jnp.float32).reshape(E, C, D)
    y, _ = JM.moe_apply_dispatch(jp, jcfg, jnp.asarray(x), capacity_factor=cf,
                                 groups=groups,
                                 token_mask=jnp.asarray(mask) if masked else None,
                                 expert_ffn_fn=lambda b: code)
    y = np.asarray(y).reshape(groups, Tg, D)[:, :, : E * C]
    want_tok = np.where((y != 0).any(1), np.argmax(y != 0, axis=1), Tg)
    want_w = y.max(1)
    w, ids, _ = JM.route_topk(jp, spec, jnp.asarray(x))
    t = lambda a: torch.from_numpy(np.asarray(a))
    slot, tok_map, w_map = PM.dispatch_maps(
        t(ids).reshape(groups, Tg, K), t(w).reshape(groups, Tg, K),
        t(mask).reshape(groups, Tg), E, C)
    np.testing.assert_array_equal(tok_map.reshape(groups, -1).numpy(), want_tok)
    np.testing.assert_array_equal(w_map.reshape(groups, -1).numpy(), want_w)
    kept = int((tok_map < Tg).sum())
    if cf < 1.0:
        assert kept < int(mask.sum()) * K  # capacity drops happened
    if cf >= 4.0:
        assert kept == int(mask.sum()) * K  # nothing dropped but pads


@pytest.mark.parametrize("cf,groups,masked", DISPATCH_CASES)
def test_moe_apply_dispatch_matches(cf, groups, masked):
    jcfg, pcfg, jp, pp, x = _moe_case()
    mask = (np.arange(32) % 5 != 1) if masked else None
    want, jaux = JM.moe_apply_dispatch(
        jp, jcfg, jnp.asarray(x), capacity_factor=cf, groups=groups,
        token_mask=None if mask is None else jnp.asarray(mask))
    got, paux = PM.moe_apply_dispatch(
        pp, pcfg, torch.from_numpy(x), capacity_factor=cf, groups=groups,
        token_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(paux["load_balance"]) == pytest.approx(
        float(jaux["load_balance"]), rel=1e-6)


def test_dispatch_without_drops_equals_dense():
    jcfg, pcfg, jp, pp, x = _moe_case()
    xt = torch.from_numpy(x)
    dense, daux = PM.moe_apply_dense(pp, pcfg, xt)
    disp, _ = PM.moe_apply_dispatch(pp, pcfg, xt, capacity_factor=8.0)
    want, _ = JM.moe_apply_dense(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(disp.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    assert float(daux["load_balance"]) > 0


# ----------------------------------------------------------------------
# attention
@pytest.mark.parametrize("window", [None, 256])
def test_attention_train_chunked_matches(model, window):
    jcfg, pcfg, params, pp = model
    S = 1024  # two query chunks of 512
    x = np.random.default_rng(5).standard_normal((1, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jattn = jax.tree.map(lambda a: a[0], params["stack"][0]["attn"])
    want = JL.attention_train(jattn, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
    pattn = pp["layers"][0]["attn"]
    pt = torch.from_numpy(pos)
    got = PL.attention_train(pattn, pcfg, torch.from_numpy(x), pt, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the chunks recomputed in the backward give the unchunked gradient
    rng = np.random.default_rng(6)
    qkv = [torch.from_numpy(rng.standard_normal((1, S, h, 16)).astype(np.float32)
                            ).requires_grad_(True) for h in (4, 2, 2)]
    grads = []
    for chunk in (512, S):
        o = PL.attention_core(*qkv, pt, pt, causal=True, window=window,
                              q_chunk=chunk)
        grads.append(torch.autograd.grad(o.square().sum(), qkv))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


# ----------------------------------------------------------------------
# model
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_train_matches(model, remat, padded):
    jcfg, pcfg, params, pp = model
    b = batch()
    if padded:
        b["pad_mask"] = np.arange(32)[None] >= np.array([[0], [3], [0], [9]])
    jl, ja = JT.forward_train(params, jcfg, jb(b), remat=remat)
    pb = PTR.to_device(b, "cpu")
    with torch.no_grad():
        pl, pa = PT.forward_train(pp, pcfg, pb, remat=remat)
    real = b["pad_mask"] if padded else np.ones((4, 32), bool)
    np.testing.assert_allclose(pl.numpy()[real], np.asarray(jl)[real],
                               rtol=0, atol=1e-4)
    assert float(pa["load_balance"]) == pytest.approx(
        float(ja["load_balance"]), rel=1e-5)


def test_pad_positions_match():
    mask = np.arange(6)[None] >= np.array([[0], [2], [5]])
    jm, jp = JT.pad_positions(jnp.asarray(mask), 6)
    pm, pp = PT.pad_positions(torch.from_numpy(mask), 6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert PT.pad_positions(None, 4)[1].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match(model, remat):
    jcfg, pcfg, params, pp = model
    b = batch(seed=1)
    (_, jm), jg = jax.value_and_grad(JTR.loss_fn, has_aux=True)(
        params, jcfg, jb(b), remat)
    pm, pg = PTR._grads(pp, pcfg, PTR.to_device(b, "cpu"), remat)
    for k in ("loss", "ce", "load_balance"):
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    n = 0
    for path, want, got in leaf_pairs(jg, pg, pcfg):
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)
        n += 1
    assert n == len(jax.tree.leaves(params))


# ----------------------------------------------------------------------
# training
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
METRICS = ("loss", "ce", "load_balance", "grad_norm")
RTOL = {"loss": 1e-5, "ce": 1e-5, "load_balance": 1e-5, "grad_norm": 1e-4,
        "lr": 1e-6}


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match(model, micro):
    jcfg, pcfg, params, pp = model
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.OptimizerConfig(**OPT),
                                        microbatches=micro))
    pstep = PTR.make_train_step(pcfg, PO.OptimizerConfig(**OPT),
                                microbatches=micro)
    jpar, js = params, JO.init_opt_state(params)
    ppar, ps = pp, PO.init_opt_state(pp)
    for step in range(4):
        b = batch(seed=10 + step)
        jpar, js, jm = jstep(jpar, js, jb(b))
        ppar, ps, pm = pstep(ppar, ps, PTR.to_device(b, "cpu"))
        for k in METRICS:
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=RTOL[k]), \
                (step, k)
    for path, want, got in leaf_pairs(jpar, ppar, pcfg):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=path)


def test_train_and_eval_ce_match(model):
    jcfg, pcfg, params, pp = model
    steps = [batch(seed=20 + i) for i in range(3)]
    evals = [batch(seed=40 + i) for i in range(2)]
    tcfg = dict(steps=3, log_every=1, eval_every=0)
    jpar, _, jh = JTR.train(params, jcfg, JO.OptimizerConfig(**OPT), iter(steps),
                            JTR.TrainerConfig(**tcfg), log=lambda _: None)
    ppar, _, ph = PTR.train(pp, pcfg, PO.OptimizerConfig(**OPT), iter(steps),
                            PTR.TrainerConfig(**tcfg), log=lambda _: None)
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == [0, 1, 2]
    for a, b in zip(jh, ph):
        for k in METRICS + ("lr",):
            assert b[k] == pytest.approx(a[k], rel=RTOL[k]), k
    assert PTR.eval_ce(ppar, pcfg, evals) == pytest.approx(
        JTR.eval_ce(jpar, jcfg, evals), rel=1e-5)


# ----------------------------------------------------------------------
# checkpoints and parameter counts
def test_checkpoints_read_both_ways(model, tmp_path):
    jcfg, pcfg, params, pp = model
    port_file, ref_file = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    PC.save(port_file, pp, pcfg, meta={"steps": 3})
    assert PC.load_meta(port_file) == JC.load_meta(port_file) == {"steps": 3}
    tmpl = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), jcfg))
    back = JC.restore(port_file, tmpl)
    for path, want, got in leaf_pairs(back, pp, pcfg):
        np.testing.assert_array_equal(got, want, err_msg=path)
    JC.save(ref_file, params, meta={"steps": 5})
    got = PC.restore(ref_file, pcfg, "cpu")
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pp)):  # sorted keys
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="checkpoint"):
        PC.restore(ref_file, pcfg.replace(d_ff=96), "cpu")


def test_params_to_numpy_inverts_params_from_numpy(model):
    jcfg, pcfg, params, pp = model
    tree = bridge.params_to_numpy(pp, pcfg)
    assert tree["tail"] == [] and len(tree["stack"]) == pcfg.pattern_period
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-draft", "mixtral-8x7b",
                                  "mixtral-offload"])
def test_count_params_analytic_matches(name):
    want = JT.count_params_analytic(jget(name))
    assert PT.count_params_analytic(pget(name)) == want
    if name.startswith("tiny"):
        params = PT.init_model(pget(name), device="cpu")
        assert sum(a.numel() for a in tree_leaves(params)) == want
        specs = PT.param_specs(pget(name))
        shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
        assert jax.tree.map(lambda s: s[0], specs,
                            is_leaf=lambda s: isinstance(s, tuple)) == shapes(params)
