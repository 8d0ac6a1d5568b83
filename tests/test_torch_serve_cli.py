"""The port's launchers (``repro_torch.launch.serve`` / ``.train``) and
its new benchmark entry points, against the JAX reference's, on the CPU.

* The cases of the reference's ``tests/test_serve_cli.py``, each run on
  both packages' parsers and resolvers where the behaviour is shared:
  ``None`` is "flag not given" and 0 a real ablation for
  ``--cache-size``/``--num-speculative``/``--num-draft-tokens``/
  ``--prefix-cache``/``--kv-host-pages``; ``--top-k-override``;
  ``--config`` as an alias.  The port's ``--num-draft-tokens 1`` run
  through ``main()`` decodes what the run without a draft decodes.
* Every flag of the reference's parser is in the port's with the same
  default, except ``--roofline-hw`` (``h100``, the port's only measured
  row; the reference's rows are refused by name) and the added
  ``--device``; the encoder-decoder (``whisper-medium``) outside
  ``--continuous`` is refused with the reference's message.
* ``main()`` under ``--device cpu`` prints the reference's ``gen:`` /
  per-request tokens for ``--offload --quantize`` and ``--continuous
  --kv-page 16`` on ``tiny-moe`` from one checkpoint the reference wrote,
  and for ``--config xlstm-1.3b --continuous`` (served ``reduced()`` on
  the CPU by both launchers) likewise.
* ``launch.train`` for 2 steps writes a checkpoint that the reference
  restores and that the port's serving CLI serves with the prefix cache,
  preemption, injected faults and the packed plane, its metrics and trace
  files passing ``tools/check_metrics_schema.py``.
* ``offload_bench``'s top-k ablation: the port's k = 1 counters equal the
  reference's on the same weights.  ``attention_bench --smoke``: the dense
  ring equals the pages bitwise, and the work lists equal the
  reference's.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import restore as jrestore
from repro.checkpoint.checkpointer import save as jsave
from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.kernels import ragged_attention as JRA
from repro.launch import serve as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.benchmarks import attention_bench, common, offload_bench
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.launch import serve as PS
from repro_torch.launch import train as PTrain

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": (JS, jget, JSpec), "port": (PS, pget, PSpec)}
both = pytest.mark.parametrize("side", list(SIDES))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_for(side, argv):
    """Exactly what ``main`` computes for ``--offload`` runs."""
    mod, get, spec = SIDES[side]
    args = mod.build_parser().parse_args(argv)
    cfg = get(args.arch)
    return mod.resolve_offload_spec(cfg.offload or spec(), args.cache_size,
                                    args.num_speculative)


@both
def test_zero_ablation_flags_respected(side):
    spec = _spec_for(side, ["--offload", "--cache-size", "0",
                            "--num-speculative", "0"])
    assert spec.cache_size == 0 and spec.num_speculative == 0


@both
def test_unset_flags_keep_arch_defaults(side):
    assert _spec_for(side, ["--offload"]) == SIDES[side][1]("tiny-moe").offload


@both
def test_partial_override_keeps_other_default(side):
    base = SIDES[side][1]("tiny-moe").offload
    spec = _spec_for(side, ["--offload", "--cache-size", "5"])
    assert spec.cache_size == 5
    assert spec.num_speculative == base.num_speculative
    spec = _spec_for(side, ["--offload", "--num-speculative", "0"])
    assert spec.cache_size == base.cache_size and spec.num_speculative == 0


@both
def test_resolve_is_identity_without_overrides(side):
    mod, _, spec = SIDES[side]
    base = spec(cache_size=4, num_speculative=1)
    assert mod.resolve_offload_spec(base) is base


@both
def test_draft_flags_unset_disable_cleanly(side):
    mod = SIDES[side][0]
    assert mod.resolve_draft(None, None) == (None, 0)
    assert mod.resolve_draft(None, 5) == (None, 0)
    args = mod.build_parser().parse_args([])
    assert mod.resolve_draft(args.draft_config, args.num_draft_tokens) == \
        (None, 0)


@both
def test_draft_zero_tokens_is_real_ablation(side):
    mod = SIDES[side][0]
    assert mod.resolve_draft("tiny-draft", 0) == (None, 0)
    assert mod.resolve_draft("tiny-draft", -3) == (None, 0)
    args = mod.build_parser().parse_args(
        ["--continuous", "--draft-config", "tiny-draft",
         "--num-draft-tokens", "0"])
    assert mod.resolve_draft(args.draft_config, args.num_draft_tokens) == \
        (None, 0)


@both
def test_draft_default_and_explicit_k(side):
    mod = SIDES[side][0]
    assert mod.resolve_draft("tiny-draft", None) == ("tiny-draft", 4)
    assert mod.resolve_draft("tiny-draft", 1) == ("tiny-draft", 1)


@both
def test_top_k_override_unset_keeps_arch_default(side):
    mod, get, _ = SIDES[side]
    cfg = get("tiny-moe")
    assert mod.resolve_top_k(cfg, None) is cfg
    assert mod.build_parser().parse_args([]).top_k_override is None


@both
def test_top_k_override_zero_is_error_not_default(side):
    mod, get, _ = SIDES[side]
    for k in (0, -2):
        with pytest.raises(ValueError, match=">= 1"):
            mod.resolve_top_k(get("tiny-moe"), k)


@both
def test_top_k_override_applies_and_clamps(side):
    mod, get, _ = SIDES[side]
    cfg = get("tiny-moe")
    assert mod.resolve_top_k(cfg, 1).moe.top_k == 1
    assert mod.resolve_top_k(cfg, 999).moe.top_k == cfg.moe.top_k
    assert mod.resolve_top_k(cfg, 1).moe.num_experts == cfg.moe.num_experts


@both
def test_top_k_override_rejects_dense_arch(side):
    mod, get, _ = SIDES[side]
    with pytest.raises(ValueError, match="dense"):
        mod.resolve_top_k(get("tiny-draft"), 1)


@both
def test_kv_features_unset_are_off(side):
    mod = SIDES[side][0]
    args = mod.build_parser().parse_args([])
    assert args.prefix_cache is None and args.kv_host_pages is None
    assert args.preemption == "off"
    assert mod.resolve_kv_features(None, "off", None) == (0, False, 0)


@both
def test_prefix_cache_zero_is_real_ablation(side):
    mod = SIDES[side][0]
    assert mod.resolve_kv_features(0, "off", None) == (0, False, 0)
    assert mod.resolve_kv_features(0, "on", None) == (0, True, 0)
    with pytest.raises(ValueError, match=">= 0"):
        mod.resolve_kv_features(-1, "off", None)


@both
def test_kv_host_pages_zero_is_recompute_only(side):
    mod = SIDES[side][0]
    assert mod.resolve_kv_features(None, "on", 0) == (0, True, 0)
    assert mod.resolve_kv_features(4, "on", 16) == (4, True, 16)
    with pytest.raises(ValueError, match=">= 0"):
        mod.resolve_kv_features(None, "on", -8)


@both
def test_kv_host_pages_without_preemption_rejected(side):
    mod = SIDES[side][0]
    for pages in (16, 0):
        with pytest.raises(ValueError, match="--preemption"):
            mod.resolve_kv_features(None, "off", pages)


@both
def test_kv_feature_flags_parse(side):
    mod = SIDES[side][0]
    args = mod.build_parser().parse_args(
        ["--continuous", "--kv-page", "8", "--prefix-cache", "0",
         "--preemption", "on", "--kv-host-pages", "0"])
    assert mod.resolve_kv_features(args.prefix_cache, args.preemption,
                                   args.kv_host_pages) == (0, True, 0)


@both
def test_config_alias_for_arch(side):
    parser = SIDES[side][0].build_parser()
    assert parser.parse_args(["--config", "xlstm-1.3b"]).arch == "xlstm-1.3b"
    assert parser.parse_args(["--arch", "tiny-moe"]).arch == "tiny-moe"


# ----------------------------------------------------------------------
def _actions(parser):
    return {a.dest: (sorted(a.option_strings), a.default, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_every_reference_flag_with_its_default():
    want, got = _actions(JS.build_parser()), _actions(PS.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest in want:
        if dest == "roofline_hw":
            continue
        assert got[dest] == want[dest], dest
    assert got["roofline_hw"][:2] == (["--roofline-hw"], "h100")
    assert got["device"][:2] == (["--device"], None)


def _run(mod, argv):
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            mod.main() if mod is JS else mod.main(argv)
    finally:
        sys.argv = old
    return buf.getvalue()


@pytest.mark.parametrize("argv,message", [
    (["--offload", "--roofline-hw", "t4", "--metrics-json", "m.json"],
     "t4.*3060.*3080m.*a100"),
    # whisper serves with --continuous; static mode is refused with the
    # reference's message (the test keeps the id of the refusal it replaced)
    pytest.param(["--config", "whisper-medium"],
                 "whisper-medium is encoder-decoder: serve it with --continuous",
                 id="argv1-item 6, sub-item 4")])
def test_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        PS.main(argv + ["--device", "cpu"])


def _generations(out):
    """The ``gen:`` lines, or the finished requests' texts in rid order."""
    gens = re.findall(r"^gen: (.*)$", out, re.M)
    if gens:
        return gens
    found = re.findall(r"req (\d+) finished .*?: ('.*')", out)
    return [t for _, t in sorted(found, key=lambda x: int(x[0]))]


def test_draft_one_token_bitwise_end_to_end():
    """``--num-draft-tokens 1`` (C = 2) through the port's ``main()``: the
    same texts as without a draft, and the spec summary printed."""
    argv = ["--continuous", "--arch", "tiny-moe", "--n-requests", "2",
            "--max-new", "8", "--max-slots", "2", "--slot-len", "64",
            "--seed", "3", "--device", "cpu"]
    base = _generations(_run(PS, argv))
    out = _run(PS, argv + ["--draft-config", "tiny-draft",
                           "--num-draft-tokens", "1"])
    assert len(base) == 2 and _generations(out) == base
    assert "[spec]" in out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The reference's seeded ``tiny-moe`` written by the reference."""
    cfg = jget("tiny-moe")
    path = tmp_path_factory.mktemp("ck") / "tiny_moe.npz"
    jsave(str(path), JT.init_model(jax.random.key(0), cfg),
          meta={"arch": cfg.name})
    return str(path)


@pytest.mark.parametrize("argv", [
    ["--offload", "--quantize", "--max-new", "5"],
    ["--continuous", "--kv-page", "16", "--n-requests", "3", "--max-new",
     "5", "--max-slots", "2", "--slot-len", "64"]],
    ids=["offload", "continuous-paged"])
def test_main_prints_reference_tokens(checkpoint, argv):
    argv = argv + ["--checkpoint", checkpoint]
    want = _generations(_run(JS, argv))
    got = _generations(_run(PS, argv + ["--device", "cpu"]))
    assert len(got) >= 2 and got == want


def test_recurrent_config_serves_reference_tokens(tmp_path):
    """``--config xlstm-1.3b --continuous``: both launchers serve its
    ``reduced()`` variant on the CPU from one checkpoint the reference
    wrote (numpy weights in its layout, ``tests/zoo_models.py``), with the
    same per-request tokens."""
    import zoo_models
    cfg = jget("xlstm-1.3b").reduced()
    path = str(tmp_path / "xlstm.npz")
    jsave(path, jax.tree.map(jax.numpy.asarray,
                             zoo_models.random_params(cfg)),
          meta={"arch": cfg.name})
    argv = ["--config", "xlstm-1.3b", "--continuous", "--n-requests", "3",
            "--max-new", "4", "--max-slots", "2", "--slot-len", "64",
            "--checkpoint", path]
    want = _generations(_run(JS, argv))
    got = _generations(_run(PS, argv + ["--device", "cpu"]))
    assert len(got) == 3 and got == want


def _load_checker():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", ROOT / "tools" / "check_metrics_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_checkpoint_serve_chain(tmp_path):
    """Two training steps, their checkpoint read by the reference, then
    served by the port's CLI through the prefix cache, preemption, an
    injected fault rate and the packed plane, with metrics and trace."""
    ck = str(tmp_path / "ck.npz")
    out = _run(PTrain, ["--steps", "2", "--seq-len", "64", "--batch-size",
                        "2", "--corpus-bytes", "200000", "--checkpoint", ck,
                        "--device", "cpu"])
    assert "[train] saved" in out and "final loss" in out
    jp = jrestore(ck, jax.eval_shape(lambda: JT.init_model(
        jax.random.key(0), jget("tiny-moe"))))
    assert jax.tree.structure(jp) is not None
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    out = _run(PS, ["--config", "tiny-moe", "--checkpoint", ck,
                    "--continuous", "--kv-page", "16", "--prefix-cache", "8",
                    "--preemption", "on", "--inject-faults",
                    "expert_fetch=0.05", "--offload", "--quantize",
                    "--n-requests", "4", "--max-new", "6", "--metrics-json",
                    str(m), "--trace", str(t), "--device", "cpu"])
    assert "[continuous] 4 requests" in out and "[faults]" in out
    checker = _load_checker()
    assert checker.check_metrics(m) == [] and checker.check_trace(t) == []


# ----------------------------------------------------------------------
# the new benchmark entry points at their smoke sizes
def test_top_k_ablation_counters_match_reference():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    prompt = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (1, 12)).astype(np.int32)
    jeng = JEngine(params, JS.resolve_top_k(jcfg, 1), jcfg.offload,
                   quantized=True)
    jtoks, js = jeng.generate(prompt, 8)
    row = offload_bench._top_k_override(
        pp, pcfg, PSpec(**{k: getattr(jcfg.offload, k) for k in
                           ("cache_size", "num_speculative", "lookahead",
                            "expert_bits", "attn_bits")}),
        prompt, 8, torch.device("cpu"), {"bytes_per_token": 1.0})
    assert row["counters"] == {"hits": js.hits, "spec_hits": js.spec_hits,
                               "demand_loads": js.demand_loads,
                               "spec_loads": js.spec_loads}
    assert row["tokens"] == np.asarray(jtoks)[0].tolist()
    assert row["bytes_per_token"] == round(js.bytes_h2d / js.n_tokens, 1)


def test_attention_bench_smoke(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "BENCH_OUT", tmp_path)
    rows = attention_bench.run(smoke=True, device="cpu")
    scaling = [r for r in rows if r["scenario"] == "decode_scaling"]
    assert [r["live_frac"] for r in scaling] == [0.125, 0.25, 0.5, 1.0]
    assert all(r["bitwise_parity_full_width"] and r["device"] == "cpu"
               for r in scaling)
    lists = [r for r in rows if r["scenario"] == "worklist"]
    assert [r["window"] for r in lists] == [None, 16]
    assert lists[1]["live_pages"] < lists[0]["live_pages"]
    # the work lists equal the reference's on the same tables
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 128, 4).astype(np.int64)
    _, (_, _, _, pages) = attention_bench._make_layouts(rng, lens, 128, 16,
                                                        2, 8)
    for win in (None, 16):
        got = attention_bench.RA.build_page_worklist(pages, lens, lens - 1,
                                                     lens - 1, 16, window=win)
        want = JRA.build_page_worklist(pages, lens, lens - 1, lens - 1, 16,
                                       window=win)
        assert all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(got, want))
    assert (tmp_path / "attention_bench.json").exists()


def test_quickstart_example_runs():
    """``python -m repro_torch.examples.quickstart`` for 3 training steps:
    the offload engine's tokens equal plain decode's (it asserts so)."""
    from repro_torch.examples import quickstart
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert quickstart.main(["--steps", "3", "--device", "cpu"]) == 0
    assert "identical: True" in out.getvalue()
