"""The port's telemetry plane (``repro_torch.obs``) against the JAX
reference's (``repro.obs``), the cases of the reference's
``tests/test_obs.py``, on ``tiny-moe`` cut to 2 layers, on the CPU.
Weights are the reference's seeded ones crossed over by
``repro_torch.bridge``; prompts are made from a seed with numpy.

* Units: the histogram's log2 buckets and quantiles equal the
  reference's on the same seeded observations; registry kind conflicts
  and declared/collected overlaps are refused; ``flatten_legacy``; the
  tracer's Chrome document equal to the reference's on the same clock.
* Snapshots: for dense, paged, offloaded, speculative, prefix + host-swap
  serving and the ``OffloadEngine``, the namespace and key sets equal the
  reference's ``expected_namespaces`` / the schema tool's
  ``expected_for_mode``, and every counter of ``engine``, ``kv``,
  ``offload``, ``prefix``, ``kv_host``, ``faults`` and ``spec``, the
  request histograms ``queue_wait_steps``/``gen_tokens`` and the step and
  window counts equal the reference's run on the same traffic (the
  timings and ``jit``'s values are not comparable: only their key sets).
  The reference's runs are shared through a module-scoped fixture.
* Tokens equal with telemetry fully on (timing + trace) and off, on the
  plain plane (dense, pages, a categorical sampler), the packed plane and
  ``OffloadEngine.generate``.
* The files the port writes pass ``tools/check_metrics_schema.py``
  (which checks against the reference's schema), and the tool rejects a
  broken one.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import OffloadSpec as JSpec
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.models import transformer as JT
from repro.obs import Telemetry as JTelemetry
from repro.obs.registry import Histogram as JHistogram
from repro.obs.schema import expected_namespaces
from repro.obs.tracing import Tracer as JTracer
from repro.serving.engine import ContinuousEngine as JContinuous
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import OffloadSpec as PSpec
from repro_torch.core import expert_pool as EP
from repro_torch.core.offload_engine import OffloadEngine as PEngine
from repro_torch.obs import Telemetry, flatten_legacy
from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.obs.schema import HISTOGRAM_FIELDS
from repro_torch.obs.tracing import PID_REQUESTS, Tracer
from repro_torch.serving.engine import ContinuousEngine as PContinuous
from repro_torch.serving.sampler import SamplerConfig

ROOT = Path(__file__).resolve().parents[1]
NEWS = [4, 7, 3, 6]
# namespaces whose every value is a count (or a ratio of counts) and so
# must equal the reference's on the same traffic
COUNTED = ("engine", "kv", "offload", "prefix", "kv_host", "faults", "spec")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as in test_torch_paper.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_checker():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", ROOT / "tools" / "check_metrics_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prompts(cfg, n, seed=0, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _shared_prefix(cfg, seed=7):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(1, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in (6, 9, 5, 7)]


def _store_leaves(store):
    return {m: {"packed": np.asarray(q.packed), "scale": np.asarray(q.scale),
                "zero": np.asarray(q.zero),
                "meta": {k: np.asarray(v) for k, v in q.meta.items()}}
            for m, q in zip(EP.EXPERT_MATS, store)}


SPEC = dict(cache_size=4, num_speculative=2, lookahead=1, expert_bits=3,
            attn_bits=4)


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    jdcfg, pdcfg = jget("tiny-draft"), pget("tiny-draft")
    dparams = JT.init_model(jax.random.key(7), jdcfg)
    pdp = bridge.params_from_numpy(jax.tree.map(np.asarray, dparams), pdcfg,
                                   "cpu")
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, pp=pp, jdcfg=jdcfg,
                pdcfg=pdcfg, dparams=dparams, pdp=pdp)


def _packed(m):
    """The reference's packed engine and a factory of the port's over its
    weights and store (``telemetry`` passed through)."""
    jeng = JEngine(m["params"], m["jcfg"], JSpec(**SPEC), quantized=True)
    pspec = PSpec(**SPEC)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  m["pcfg"], "cpu")
    store = bridge.store_from_numpy(_store_leaves(jeng.store), m["pcfg"],
                                    pspec, "cpu")

    def port(telemetry=None):
        return PEngine(pp, m["pcfg"], pspec, quantized=True, store=store,
                       device="cpu", telemetry=telemetry)
    return jeng, port


# each mode: (engine kwargs, prompts, priorities, expected_namespaces kw)
MODES = {
    "dense": ({}, None, None, dict(kv_layout="dense", plane="plain")),
    "paged": (dict(kv_page=16), None, None,
              dict(kv_layout="paged", plane="plain")),
    "offloaded": (dict(offload=True), None, None,
                  dict(kv_layout="dense", offloaded=True,
                       plane="packed_pipelined")),
    "speculative": (dict(draft=3), None, None,
                    dict(kv_layout="dense", plane="plain", speculative=True)),
    # a pool of 9 pages of 4 for 2 slots: a priority admission swaps a
    # row out, another recomputes, and a late request hits the prefix
    "prefix_kv_host": (dict(kv_page=4, kv_pages_total=9,
                            prefix_cache_pages=4, preemption=True,
                            kv_host_pages=8),
                       "shared", [0, 5, 0, 0],
                       dict(kv_layout="paged", plane="plain",
                            prefix_cache=True, kv_host=True)),
}


def _serve(cls, m, side, mode, telemetry, offload=None, sampler=None,
           seed=0):
    kw, prompts, pri, _ = MODES[mode]
    kw = dict(kw)
    cfg = m["jcfg"] if side == "ref" else m["pcfg"]
    params = m["params"] if side == "ref" else m["pp"]
    if kw.pop("offload", False):
        params = None
        kw["offload"] = offload
    k = kw.pop("draft", 0)
    if k:
        kw.update(num_draft_tokens=k,
                  draft_params=m["dparams"] if side == "ref" else m["pdp"],
                  draft_cfg=m["jdcfg"] if side == "ref" else m["pdcfg"])
    if side == "port":
        kw["device"] = "cpu"
        kw["check_invariants"] = True
    kw.setdefault("max_slots", 2)
    eng = cls(params, cfg, slot_len=48, eos_id=None, sampler=sampler,
              seed=seed, telemetry=telemetry, **kw)
    prompts = (_shared_prefix(m["jcfg"]) if prompts == "shared"
               else _prompts(m["jcfg"], 4, seed=5))
    reqs = [eng.submit(p, n, priority=q) for p, n, q in
            zip(prompts, NEWS, pri or [0] * 4)]
    eng.run(max_steps=300)
    assert all(r.state == "finished" for r in reqs)
    return eng, [r.generated for r in reqs]


@pytest.fixture(scope="module")
def runs(model):
    """Every mode served by both packages with telemetry fully on, the
    port also with it off; and the OffloadEngine's generate both ways."""
    jeng, port_engine = _packed(model)
    out = {}
    for mode in MODES:
        off = port_engine() if mode == "offloaded" else None
        j = _serve(JContinuous, model, "ref", mode,
                   JTelemetry(timing=True, trace=True), offload=jeng)
        p = _serve(PContinuous, model, "port", mode,
                   Telemetry(timing=True, trace=True), offload=off)
        p_off = _serve(PContinuous, model, "port", mode, None, offload=off)
        out[mode] = dict(ref=j, port=p, port_off=p_off)
    prompt = _prompts(model["jcfg"], 1, seed=2)[0][None]
    jon = JEngine(model["params"], model["jcfg"], JSpec(**SPEC),
                  quantized=True, telemetry=JTelemetry(timing=True,
                                                       trace=True))
    jtoks, _ = jon.generate(prompt, 4)
    pon = port_engine(Telemetry(timing=True, trace=True))
    ptoks, pstats = pon.generate(prompt, 4)
    poff = port_engine()
    otoks, ostats = poff.generate(prompt, 4)
    out["offload_engine"] = dict(ref=jon, port=pon, off=poff,
                                 toks=(jtoks, ptoks, otoks),
                                 stats=(pstats, ostats))
    return out


# ----------------------------------------------------------------------
# registry / histogram / tracer / flatten units
def test_histogram_log_buckets_and_quantiles():
    rng = np.random.default_rng(0)
    values = [1.0, 2.0, 4.0, 4.5, 100.0, 0.0] + list(
        rng.lognormal(1.0, 2.0, 200)) + list(rng.integers(0, 9, 50))
    h, j = Histogram(), JHistogram()
    for v in values:
        h.observe(v)
        j.observe(v)
    assert h.snapshot() == j.snapshot()
    small = Histogram()
    for v in (1.0, 2.0, 4.0, 4.5, 100.0):
        small.observe(v)
    s = small.snapshot()
    assert s["min"] <= s["p50"] <= s["p95"] <= s["max"]
    assert s["buckets"] == {"1": 1, "2": 1, "3": 2, "7": 1}


def test_histogram_empty_snapshot_is_total():
    s = Histogram().snapshot()
    assert set(s) == HISTOGRAM_FIELDS and s == JHistogram().snapshot()


def test_registry_kind_conflict_rejected():
    r = MetricsRegistry()
    r.counter("ns", "x")
    r.counter("ns", "x")  # the same kind again is the same metric
    with pytest.raises(ValueError):
        r.gauge("ns", "x")


def test_registry_collector_overlap_asserts():
    r = MetricsRegistry()
    r.counter("engine", "steps")
    r.register_collector("engine", lambda: {"steps": 3})
    with pytest.raises(AssertionError):
        r.snapshot()


def test_flatten_legacy_prefixes_and_collisions():
    flat = flatten_legacy({"engine": {"steps": 3}, "kv": {"slots_free": 1},
                           "offload": {"hits": 2}, "step": {"timed": 4}})
    assert flat == {"steps": 3, "kv_slots_free": 1, "offload_hits": 2,
                    "step_timed": 4}
    with pytest.raises(AssertionError):
        flatten_legacy({"kv": {"x": 1}, "engine": {"kv_x": 2}})


def test_tracer_chrome_format_equals_reference():
    docs = []
    for cls in (Tracer, JTracer):
        clock = iter(range(0, 10_000_000, 1_000_000))
        tr = cls(clock_ns=lambda: next(clock))
        assert tr.request_track(7) == 7
        tr.request_track(7)  # no second thread-name event
        tr.complete("decode", PID_REQUESTS, 7, 10.0, 25.0,
                    args={"tokens": 3})
        tr.instant("finish", PID_REQUESTS, 7)
        docs.append(tr.to_chrome())
    assert docs[0] == docs[1]
    names = [(e["ph"], e["name"]) for e in docs[0]["traceEvents"]]
    assert names.count(("M", "thread_name")) == 3


# ----------------------------------------------------------------------
# snapshots: the reference's key sets, its counters on the same traffic
def _key_sets(snap):
    return {ns: set(v) for ns, v in snap.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_continuous_snapshot_matches_reference(runs, mode):
    jeng, jtoks = runs[mode]["ref"]
    peng, ptoks = runs[mode]["port"]
    assert ptoks == jtoks
    want = {ns: set(v) for ns, v in
            expected_namespaces(timing=True, roofline=True,
                                **MODES[mode][3]).items()}
    js, ps = jeng.metrics(), peng.metrics()
    assert _key_sets(ps) == want == _key_sets(js)
    for ns in COUNTED:
        if ns in want:
            assert ps[ns] == js[ns], ns
    for key in ("submitted", "finished", "queue_wait_steps", "gen_tokens"):
        assert ps["request"][key] == js["request"][key], key
    assert ps["step"]["timed"] == js["step"]["timed"]
    assert set(ps["step"]["wall_ms"]) == HISTOGRAM_FIELDS
    for key in ("windows", "window_steps", "prefix_hit_tokens",
                "kv_swap_bytes_per_token", "naive_h2d_bytes_per_token",
                "measured_h2d_bytes_per_token"):
        assert ps["roofline"][key] == pytest.approx(js["roofline"][key],
                                                    rel=1e-12), key
    assert ps["roofline"]["hw"] == "h100"
    if mode == "offloaded":
        assert ps["offload"]["demand_loads"] + ps["offload"]["spec_loads"] > 0
        assert ps["roofline"]["h2d_savings_ratio"] > 1.0
    if mode == "prefix_kv_host":
        assert ps["kv_host"]["preemptions"] > 0 < ps["kv_host"]["recomputes"]
        assert ps["kv_host"]["swap_in_bytes"] > 0
        assert ps["prefix"]["prefills_skipped"] > 0
    # stats() is the flat projection of the same snapshot
    flat = flatten_legacy(ps)
    assert {k for k in peng.stats()} == set(flat)


def test_continuous_snapshot_telemetry_off(runs):
    jeng, _ = runs["dense"]["ref"]
    peng, _ = runs["dense"]["port_off"]
    want = {ns: set(v) for ns, v in expected_namespaces(
        kv_layout="dense", timing=False).items()}
    assert _key_sets(peng.metrics()) == want
    s = peng.stats()
    for key in ("steps", "tokens", "tokens_per_step", "finished",
                "kv_slots_in_use", "kv_slots_free", "jit_hits"):
        assert key in s, f"stats() lost {key!r}"
    # the reference's run of the same traffic (with telemetry on)
    js = jeng.stats()
    counted = [k for k in s if not k.startswith("jit_")]
    assert {k: s[k] for k in counted} == {k: js[k] for k in counted}


def test_offload_engine_snapshot_matches_reference(runs):
    r = runs["offload_engine"]
    checker = _load_checker()
    for eng, timing in ((r["off"], False), (r["port"], True)):
        want = checker.expected_for_mode({
            "engine": "offload", "timing": timing,
            "plane": "packed_pipelined"})
        snap = eng.metrics()
        assert _key_sets(snap) == {ns: set(v) for ns, v in want.items()}
    js, ps = r["ref"].metrics(), r["port"].metrics()
    assert _key_sets(ps) == _key_sets(js)
    assert ps["offload"] == js["offload"]
    for key in ("submitted", "finished", "queue_wait_steps", "gen_tokens"):
        assert ps["request"][key] == js["request"][key], key
    assert ps["request"]["finished"] == 1
    assert ps["roofline"]["windows"] == js["roofline"]["windows"] == 1


# ----------------------------------------------------------------------
# the hot-path contract: the same tokens with telemetry on or off
@pytest.mark.parametrize("mode", ["dense", "paged", "offloaded"])
def test_parity_telemetry_on_off(runs, mode):
    assert runs[mode]["port"][1] == runs[mode]["port_off"][1]


def test_parity_telemetry_on_off_categorical(model):
    sampler = SamplerConfig(kind="categorical")
    _, off = _serve(PContinuous, model, "port", "dense", None,
                    sampler=sampler, seed=11)
    _, on = _serve(PContinuous, model, "port", "dense",
                   Telemetry(timing=True, trace=True), sampler=sampler,
                   seed=11)
    assert on == off


def test_parity_offload_engine_generate(runs):
    r = runs["offload_engine"]
    jtoks, ptoks, otoks = r["toks"]
    assert (ptoks == otoks).all() and (ptoks == np.asarray(jtoks)).all()
    on, off = r["stats"]
    assert dataclasses.asdict(on) == dataclasses.asdict(off)


# ----------------------------------------------------------------------
# the written files against the schema tool
def test_metrics_and_trace_files_pass_the_checker(runs, tmp_path):
    checker = _load_checker()
    cases = {
        "dense": {"engine": "continuous", "kv_layout": "dense",
                  "offloaded": False, "plane": "plain"},
        "speculative": {"engine": "continuous", "kv_layout": "dense",
                        "offloaded": False, "plane": "plain",
                        "speculative": True},
        "prefix_kv_host": {"engine": "continuous", "kv_layout": "paged",
                           "offloaded": False, "plane": "plain",
                           "prefix_cache": True, "kv_host": True},
        "offload_engine": {"engine": "offload", "offloaded": True,
                           "plane": "packed_pipelined"}}
    for name, mode in cases.items():
        r = runs[name]
        eng = r["port"] if name == "offload_engine" else r["port"][0]
        mpath, tpath = tmp_path / f"{name}.m.json", tmp_path / f"{name}.t.json"
        eng.obs.write_metrics(mpath, dict(mode, arch="tiny-moe", timing=True,
                                          roofline=True))
        eng.obs.write_trace(tpath)
        assert checker.check_metrics(mpath) == [], name
        assert checker.check_trace(tpath) == [], name
    # the reference's OffloadEngine writes no step span: its trace fails
    # the tool's per-step check, which the port's passes
    jpath = tmp_path / "ref_offload.t.json"
    runs["offload_engine"]["ref"].obs.write_trace(jpath)
    assert any("per-step" in e for e in checker.check_trace(jpath))
    # and the tool rejects drift
    doc = json.loads((tmp_path / "dense.m.json").read_text())
    del doc["metrics"]["engine"]["steps"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert checker.check_metrics(bad), "the checker passed a broken snapshot"
