"""The port's paper measurements against the JAX reference's, on the CPU.

One ``tiny-moe`` (4 layers, d 64) is trained by the reference for four
steps on the byte corpus and crossed over by ``repro_torch.bridge``;
each package collects its own routing trace of it over the same 64
held-out tokens.

* The benchmark modules at their quick size, each fed its own package's
  trace or model: ``fig2_lru`` and ``fig2_spec`` rows equal to the
  reference's (hit ratios exactly, recalls within 1e-12);
  ``table1_quant`` rows with the projected Mixtral GB exactly and the
  eval ce within 1e-4 (float32 forward in another order, quantized the
  same way); ``table2_speed``'s H100 rows equal to the reference's cost
  model on the same row and the reference's replayed statistics (to its
  three printed decimals).
* ``replay_policies`` statistics exactly equal; ``tokens_per_second``,
  ``active_param_bytes``, ``kv_read_bytes_per_token`` and
  ``expert_bytes`` equal on one shared ``Hardware`` instance;
  ``OffloadStats.per_token`` and ``throughput_estimate`` equal.
* ``offload_bench --trained --smoke`` on the CPU: every plane's tokens
  and counters equal to the reference's packed engine.
* ``offload_bench --speculative``: its baseline and replay-draft rows
  carry the reference's engine's hit ratios and h2d bytes per token.
* The harness refuses an unknown suite and runs ``kernels`` (its quick
  rows on the CPU), and the recipe's
  checkpoint and trace are cached and read back under the port's own
  directory.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import benchmarks.fig2_lru as JF2L
import benchmarks.fig2_spec as JF2S
import benchmarks.table1_quant as JT1
from repro.configs import get_config as jget
from repro.core import cost_model as JCM
from repro.core import offload_engine as JOE
from repro.core import trace as JTRACE
from repro.data import pipeline as JD
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch.benchmarks import (common, fig2_lru, fig2_spec,
                                    offload_bench, run as bench_run,
                                    table1_quant, table2_speed)
from repro_torch.configs import get_config as pget
from repro_torch.core import cost_model as PCM
from repro_torch.core import offload_engine as POE
from repro_torch.core import trace as PTRACE
from repro_torch.quant.hqq import tree_leaves

SMALL = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)


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


@pytest.fixture(scope="module")
def trained():
    jcfg = jget("tiny-moe").replace(**SMALL)
    pcfg = pget("tiny-moe").replace(**SMALL)
    ds = JD.PackedDataset(JD.DataConfig(seq_len=32, batch_size=4,
                                        max_bytes=200_000))
    params, _, _ = JTR.train(
        JT.init_model(jax.random.key(3), jcfg), jcfg,
        JO.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=4),
        ds.batches(), JTR.TrainerConfig(steps=4, log_every=100),
        log=lambda _: None)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    tokens = next(JD.PackedDataset(JD.DataConfig(
        seq_len=64, batch_size=1, max_bytes=200_000)).eval_batches(1))["tokens"]
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, pp=pp,
                jtrace=JTRACE.collect_trace(params, jcfg, tokens),
                ptrace=PTRACE.collect_trace(pp, pcfg, tokens, device="cpu"))


@pytest.fixture
def benches(trained, monkeypatch, tmp_path):
    """Both packages' benchmark modules fed the shared trained model and
    their own traces; their JSON goes to a temporary directory."""
    t = trained
    monkeypatch.setattr(common, "get_trace", lambda n=None, device=None: t["ptrace"])
    monkeypatch.setattr(common, "get_trained_tiny_moe",
                        lambda steps=None, device=None: (t["pp"], t["pcfg"]))
    monkeypatch.setattr(common, "BENCH_OUT", tmp_path)
    for mod in (JF2L, JF2S):
        monkeypatch.setattr(mod, "get_trace", lambda n=None: t["jtrace"])
    monkeypatch.setattr(JT1, "get_trained_tiny_moe",
                        lambda steps=None: (t["params"], t["jcfg"]))
    for mod in (JF2L, JF2S, JT1):
        monkeypatch.setattr(mod, "emit", lambda rows, name: None)
    return t


def test_traces_agree(trained):
    np.testing.assert_array_equal(trained["ptrace"]["ids"],
                                  trained["jtrace"]["ids"])


def test_fig2_lru_rows_match(benches, tmp_path):
    got = fig2_lru.run(quick=True, device="cpu")
    assert got == JF2L.run(quick=True)
    assert (tmp_path / "fig2_lru.json").exists()


def test_fig2_spec_rows_match(benches):
    got, want = fig2_spec.run(quick=True, device="cpu"), JF2S.run(quick=True)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for a, b in zip(got, want):
        if "recall" in b:
            assert a["recall"] == pytest.approx(b["recall"], abs=1e-12)
        else:
            assert a == b


def test_table1_rows_match(benches):
    got, want = table1_quant.run(quick=True, device="cpu"), JT1.run(quick=True)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for a, b in zip(got, want):
        assert a["mixtral_proj_gb"] == b["mixtral_proj_gb"]
        assert a["eval_ce"] == pytest.approx(b["eval_ce"], abs=1e-4)


def test_table2_rows_match_the_reference_cost_model(benches):
    rows = table2_speed.run(quick=True, device="cpu")
    hw = JCM.Hardware(**dataclasses.asdict(PCM.HARDWARE["h100"]))
    tr = benches["jtrace"]
    mixtral = jget("mixtral-8x7b")
    scale = mixtral.moe_layer_count / tr["ids"].shape[1]
    stats = JCM.replay_policies(tr["ids"], tr["hiddens"], tr["routers"],
                                k=4, n_spec=2, lookahead=1)
    want = {}
    for r in rows:
        if "tokens_per_s" not in r:
            continue
        ts = stats[r["policy"]]
        ts = JCM.TokenStats(*(v * scale for v in (ts.demand_loads, ts.spec_loads,
                                                  ts.hits, ts.spec_hits)))
        want[r["policy"], r["bits"]] = JCM.tokens_per_second(
            mixtral, hw, ts, r["bits"], naive=r["policy"] == "naive")
        assert r["hw"] == "h100"
        assert r["tokens_per_s"] == round(want[r["policy"], r["bits"]], 3)
    assert len(want) == 8
    ordered = (want["full", 2] > want["no_spec", 2] > want["no_lru_no_spec", 2]
               > want["naive", 2])
    assert {"name": "table2_policy_ordering", "derived": str(ordered)} in rows


# ----------------------------------------------------------------------
@pytest.mark.parametrize("k,n_spec", [(2, 2), (4, 2), (1, 1)])
def test_replay_policies_exactly_equal(trained, k, n_spec):
    tr = trained["ptrace"]
    args = (tr["ids"], tr["hiddens"], tr["routers"])
    got = PCM.replay_policies(*args, k=k, n_spec=n_spec)
    want = JCM.replay_policies(*args, k=k, n_spec=n_spec)
    assert got.keys() == want.keys()
    for pol in got:
        assert dataclasses.asdict(got[pol]) == dataclasses.asdict(want[pol]), pol


HW = JCM.Hardware("shared", 20.4, 2039.0, 0.55, 1.2e-3, 0.8e-3, 80)


@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-8x7b", "mixtral-offload"])
def test_cost_model_matches_on_one_hardware_instance(name):
    jc, pc = jget(name), pget(name)
    ts = (3.5, 1.25, 40.0, 2.0)
    for bits in (2, 3, 4, 16):
        assert PCM.expert_bytes(pc, bits) == JCM.expert_bytes(jc, bits)
        assert PCM.active_param_bytes(pc, bits, 4) == \
            JCM.active_param_bytes(jc, bits, 4)
        for naive in (False, True):
            for ctx in (0.0, 1000.0, 10_000.0):
                got = PCM.tokens_per_second(pc, HW, PCM.TokenStats(*ts), bits,
                                            naive=naive, context_len=ctx)
                want = JCM.tokens_per_second(jc, HW, JCM.TokenStats(*ts), bits,
                                             naive=naive, context_len=ctx)
                assert got == want, (bits, naive, ctx)
    assert PCM.kv_read_bytes_per_token(pc, 5000.0) == \
        JCM.kv_read_bytes_per_token(jc, 5000.0)
    assert PCM.recurrent_state_bytes(pc) == JCM.recurrent_state_bytes(jc) == 0


def test_hardware_has_only_the_h100_row():
    assert list(PCM.HARDWARE) == ["h100"]
    assert PCM.HARDWARE["h100"].name.startswith("NVIDIA H100")


def test_per_token_and_throughput_estimate_match(trained):
    pp, pcfg, jcfg = trained["pp"], trained["pcfg"], trained["jcfg"]
    counts = dict(n_tokens=7, hits=30, spec_hits=5, demand_loads=9,
                  spec_loads=11, expert_bytes=1234.0)
    got = POE.OffloadStats(**counts).per_token()
    want = JOE.OffloadStats(**counts).per_token()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    hw = JCM.Hardware(**dataclasses.asdict(PCM.HARDWARE["h100"]))
    for quantized in (True, False):
        eng = POE.OffloadEngine(pp, pcfg, quantized=quantized, device="cpu")
        _, stats = eng.generate(np.arange(1, 7)[None], 4)
        bits = pcfg.offload.expert_bits if quantized else 16
        want = JCM.tokens_per_second(
            jcfg, hw, JOE.OffloadStats(**{f.name: getattr(stats, f.name) for f in
                                         dataclasses.fields(stats)}).per_token(),
            bits, pcfg.offload.attn_bits)
        assert eng.throughput_estimate(stats, "h100") == want


# ----------------------------------------------------------------------
def test_offload_bench_planes_match_the_reference(benches):
    rows = offload_bench.run(smoke=True, trained=True, device="cpu")
    prompt = np.random.default_rng(0).integers(
        1, benches["jcfg"].vocab_size, (1, 12)).astype(np.int32)
    eng = JOE.OffloadEngine(benches["params"], benches["jcfg"],
                            benches["jcfg"].offload, quantized=True)
    toks, st = eng.generate(prompt, 8)
    planes = [r for r in rows if r["variant"] in offload_bench.VARIANTS]
    assert [r["variant"] for r in planes] == list(offload_bench.VARIANTS)
    for r in planes:
        assert r["tokens"] == np.asarray(toks)[0].tolist(), r["variant"]
        assert r["counters"] == {"hits": st.hits, "spec_hits": st.spec_hits,
                                 "demand_loads": st.demand_loads,
                                 "spec_loads": st.spec_loads}, r["variant"]
        assert r["launches"] == {} and r["device"] == "cpu"


def test_speculative_scenario_is_refused(benches):
    """The speculative scenario is no longer refused: on the shared
    trained model it runs, and its baseline and replay-draft rows carry
    the reference's engine's hit ratios and h2d bytes per token on the
    same weights (pipelined plane, cache 6 of 8, k = 4, acceptance 1.0)."""
    from repro.core.draft import ReplayDraft as JReplay
    rows = {r["variant"]: r for r in offload_bench.run(
        smoke=True, trained=True, speculative=True, device="cpu")}
    jcfg = benches["jcfg"]
    prompt = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (1, 12)).astype(np.int32)
    eng = JOE.OffloadEngine(benches["params"], jcfg,
                            dataclasses.replace(jcfg.offload, cache_size=6),
                            quantized=True)
    toks, base = eng.generate(prompt, 8)
    ref = np.concatenate([prompt[0], np.asarray(toks)[0]])
    _, spec = eng.generate(prompt, 8, draft=JReplay(
        ref, vocab_size=jcfg.vocab_size), num_draft_tokens=4)
    for variant, st in (("spec_baseline", base), ("speculative", spec)):
        assert rows[variant]["hit_ratio"] == round(st.hit_ratio, 4), variant
        assert rows[variant]["bytes_per_token"] == round(
            st.bytes_h2d / max(1, st.n_tokens), 1), variant
    assert rows["spec_summary"]["acceptance_rate"] == 1.0


@pytest.mark.parametrize("only,match", [("kernels", None),
                                        ("kernels,kernels", None),
                                        ("fig2_lru,nope", "unknown")])
def test_harness_refuses_unported_suites(only, match, monkeypatch, tmp_path,
                                         capsys):
    """An unknown suite is refused.  ``kernels`` is ported: on the CPU its
    quick run prints the reference's quick rows under the port's names
    (the plain versions; no kernel runs there), once however often it is
    named."""
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            bench_run.main(["--only", only, "--device", "cpu"])
        return
    monkeypatch.setattr(common, "BENCH_OUT", tmp_path)
    bench_run.main(["--only", only, "--quick", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln.split(",") for ln in lines[1:] if not ln.startswith("[")]
    assert [r[0] for r in rows] == [
        "dequant_matmul_plain_2bit", "dequant_matmul_plain_4bit",
        "dequant_matmul_plain_8bit", "flash_attention_plain",
        "model_chunked_attention"]
    assert all(float(r[1]) > 0 for r in rows)
    assert (tmp_path / "kernels.json").exists()


def test_recipe_checkpoint_and_trace_are_cached(monkeypatch, tmp_path):
    """``get_trained_tiny_moe`` trains with the recipe, saves under the
    port's artifact directory and reads the file back on the next call;
    ``get_trace`` caches the same way."""
    assert common.ART.parts[-3:] == ("experiments", "torch", "artifacts")
    assert common.BENCH_OUT.parts[-3:] == ("experiments", "torch", "bench")
    monkeypatch.setattr(common, "ART", tmp_path)
    monkeypatch.setattr(common, "TRAIN_STEPS", 2)
    params, cfg = common.get_trained_tiny_moe(device="cpu")
    assert common.checkpoint_path(2).exists() and cfg.name == "tiny-moe"
    again, _ = common.get_trained_tiny_moe(device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert a.dtype == b.dtype and (a == b).all()
    tr = common.get_trace(16, device="cpu")
    assert tr["ids"].shape == (16, 6, 2) and common.trace_path(16).exists()
    np.testing.assert_array_equal(common.get_trace(16, device="cpu")["ids"],
                                  tr["ids"])
