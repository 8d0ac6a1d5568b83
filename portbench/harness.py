"""One run of one cell: the program built from the seed, warmed up, driven
for the measured window, and its outputs collected for the judge.

The configuration file (``portbench/configs/<config>.json``) holds the
model as it is run; :func:`port_config` maps it onto the program's
``ModelConfig``.  Every cell drives ``ContinuousEngine`` over the packed
offload engine, on pages, admission in budgeted chunks; the traffic mix
(``portbench/traffic/<mix>.json``) sets the engine's settings and a
closed loop of ``clients`` that each send their next request as soon as
the last one finishes.  The loop runs in set-up for at least
``warmup_steps`` engine steps and until every request of its opening
burst has had its first token: every shape the window uses (a full and
a partial chunk, decode at many rows) has run, and the window opens
past the burst.

Every token's host time is taken when the engine hands it over (after
the step's token read, which waits for the device).  The counters a run
reads are the program's own (``ContinuousEngine.stats()``, the pool's),
taken as deltas over the window, beside two the harness keeps around the
executor's entry points: decode rows and prompt tokens admitted.
"""
from __future__ import annotations

import contextlib
import gc
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from portbench import weights as W
from portbench.traffic import generator as TR

HERE = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no configuration {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of the configuration file ``cfg``."""
    from repro_torch.configs.base import ModelConfig, MoESpec, OffloadSpec
    off = cfg["offload"]
    window = cfg.get("sliding_window")
    return ModelConfig(
        name=cfg["name"], arch_type="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
        block_pattern=("swa+moe",) if window else ("attn+moe",),
        moe=MoESpec(num_experts=cfg["num_local_experts"],
                    top_k=cfg["num_experts_per_tok"]),
        offload=OffloadSpec(cache_size=off["cache_size"],
                            num_speculative=off["num_speculative"],
                            lookahead=off["lookahead"],
                            expert_bits=off["expert_bits"],
                            attn_bits=off["attn_bits"]),
        sliding_window=window, mlp_act="swiglu", norm="rmsnorm",
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"])


def build_engine(cfg: dict, seed: int, device, plane: str):
    """The program's packed offload engine over the seed's raw weights: the
    dense ones as the program's parameter tree (its set-up quantizes the
    attention projections), each layer's raw experts quantized by the
    program (``expert_pool.quantize_experts``) into its pinned host store
    as soon as they are drawn, as ``init_packed_model`` does with its own
    draw."""
    from repro_torch.core import expert_pool as EP
    from repro_torch.core.offload_engine import OffloadEngine, quantize_for_offload
    pcfg = port_config(cfg)
    dev = torch.device(device)
    d = W.dense(cfg, seed, dev)
    L = cfg["num_hidden_layers"]
    nrm = lambda i: {"scale": d["norms"][i]}
    params = {"embed": {"table": d["embed"]}, "final_norm": nrm(2 * L),
              "layers": [{"norm1": nrm(2 * l),
                          "attn": {k: d[k][l] for k in ("wq", "wk", "wv", "wo")},
                          "norm2": nrm(2 * l + 1),
                          "moe": {"router": d["router"][l]}} for l in range(L)]}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = {"w": d["lm_head"]}
    store = None
    for l in range(L):
        qts = EP.quantize_experts(W.experts(cfg, seed, l, dev),
                                  pcfg.offload.expert_bits)
        if store is None:
            store = EP.new_store(EP.RecordLayout.of(qts, 1), L,
                                 cfg["num_local_experts"], dev)
        EP.write_layer(store, l, qts)
        del qts
    exec_params, _, store = quantize_for_offload(
        params, pcfg, pcfg.offload, pack_experts=True, device=dev, store=store)
    return OffloadEngine(exec_params, pcfg, pcfg.offload, quantized=True,
                         store=store, device=dev,
                         pipelined=plane == "packed_pipelined")


@dataclass
class ReqRecord:
    index: int
    prompt: np.ndarray
    max_new: int
    submit_t: float
    token_t: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done_t: Optional[float] = None
    failed: bool = False


@dataclass
class Run:
    """What the metric readers read (``portbench/metrics``)."""
    cfg: dict
    mix: dict
    seconds: float
    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    requests: List[ReqRecord] = field(default_factory=list)
    counters: dict = field(default_factory=dict)  # window deltas
    trace: Optional[dict] = None
    peak_window_bytes: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Runner:
    """Drives one cell's traffic through the program (module docstring)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, log=None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.log = log or (lambda msg: None)
        t = time.perf_counter()
        self.eng = build_engine(cfg, seed, self.dev, mix["plane"])
        _sync(self.dev)
        self.log(f"set-up: weights, HQQ packing, store and the program's "
                 f"set-up {time.perf_counter() - t:.2f} s")
        self.ex = self.eng._exec
        self.tracer = None
        self.ce = None
        self.pool = None                  # the engine's pool state
        self.calls = [0, 0, 0]  # decode calls, their active rows, prompt tokens
        ex = self.ex
        decode, chunk_row, init_pool = (ex.decode, ex.prefill_chunk_row,
                                        ex.init_pool_state)

        def counted_decode(state, tokens, pstate=None, active=None, **kw):
            self.calls[0] += 1
            self.calls[1] += (int(tokens.shape[0]) if active is None
                              else int(np.count_nonzero(active)))
            return decode(state, tokens, pstate, active, **kw)

        def counted_chunk_row(state, tokens, slot):
            self.calls[2] += int(tokens.shape[1])
            return chunk_row(state, tokens, slot)

        def kept_pool(*a, **kw):
            self.pool = init_pool(*a, **kw)
            return self.pool

        ex.decode, ex.prefill_chunk_row = counted_decode, counted_chunk_row
        ex.init_pool_state = kept_pool
        self.gen = TR.requests(mix, seed, cfg["vocab_size"])
        self.records: List[ReqRecord] = []
        self._by_req = {}

    # -- counters ---------------------------------------------------------
    @staticmethod
    def _pool_counts(st) -> np.ndarray:
        return np.append(np.asarray(st.counts, np.int64), int(st.h2d_bytes))

    def counters(self) -> dict:
        c = (np.zeros(5, np.int64) if self.pool is None
             else self._pool_counts(self.pool))
        out = {"hits": int(c[0]), "spec_hits": int(c[1]),
               "demand_loads": int(c[2]), "spec_loads": int(c[3]),
               "pool_h2d_bytes": int(c[4]),
               "prefill_h2d_bytes": int(self.ex.prefill_tier.h2d_bytes),
               "decode_calls": self.calls[0], "decode_rows": self.calls[1],
               "prompt_tokens": self.calls[2]}
        if self.ce is not None:
            st = self.ce.metrics()["engine"]
            out.update(engine_steps=int(st["steps"]),
                       engine_decode_tokens=int(st["decode_tokens"]))
        return out

    def h2d_now(self) -> int:
        c = self.counters()
        return c["pool_h2d_bytes"] + c["prefill_h2d_bytes"]

    def _span(self, label):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(label)

    # -- the continuous engine ------------------------------------------
    def start(self):
        from repro_torch.serving.engine import ContinuousEngine
        # the mix's engine settings are the engine's own keyword arguments
        self.ce = ContinuousEngine(None, self.eng.cfg, offload=self.eng,
                                   eos_id=None, seed=0, **self.mix["engine"])
        t = time.perf_counter()
        for _ in range(self.mix["clients"]):
            self._submit()
        first = list(self.records)
        steps = 0
        # the loop's opening burst (every client at once, half of them
        # queued for a slot) is over once each of its requests has had its
        # first token: from then on every request waits behind the loop's
        # own completions, as in the window
        while steps < self.mix["warmup_steps"] or any(not r.token_t for r in first):
            self._step()
            steps += 1
        _sync(self.dev)
        self.log(f"set-up: warm-up, {steps} engine steps "
                 f"{time.perf_counter() - t:.2f} s")

    def _submit(self):
        r = next(self.gen)
        rec = ReqRecord(r.index, r.prompt, r.max_new, time.perf_counter())

        def on_token(req, tok, rec=rec):
            rec.token_t.append(time.perf_counter())
            rec.tokens.append(int(tok))
        rec.req = self.ce.submit(r.prompt, r.max_new, on_token=on_token)
        self._by_req[id(rec.req)] = rec
        self.records.append(rec)
        if rec.req.state == "finished":  # refused at the door
            rec.failed, rec.done_t = True, rec.submit_t

    def _step(self):
        with self._span("engine.step"):
            finished = self.ce.step()
        now = time.perf_counter()
        for req in finished:
            rec = self._by_req.pop(id(req))
            rec.done_t = now
            rec.failed = req.status != "completed"
            self._submit()  # the client's next request, no think time
        return now

    def window(self, run: Run):
        tr = self.tracer
        if tr is not None:
            tr.start()  # the profiler's own start-up stays out of the window
        c0 = self.counters()
        run.t0 = time.perf_counter()
        while True:
            now = self._step()
            if tr is not None and tr.on:
                tr.step()
                if now - tr.t0 >= self.mix["trace_seconds"]:
                    tr.stop()
            if now - run.t0 >= run.seconds:
                break
        run.t1 = now
        if tr is not None and tr.on:
            tr.stop()
        self._close(run, c0)

    # -----------------------------------------------------------------------
    def _close(self, run: Run, c0: dict):
        _sync(self.dev)
        c1 = self.counters()
        run.counters = {k: c1[k] - c0[k] for k in c1}
        run.requests = list(self.records)

    def free(self):
        """Drop the program's state (engine, pools, host store)."""
        if self.tracer is not None:
            self.tracer.uninstall()
        for name in ("ce", "eng", "ex", "pool", "gen"):
            self.__dict__.pop(name, None)
        for rec in self.records:
            rec.__dict__.pop("req", None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def finished_in_window(run: Run) -> List[ReqRecord]:
    return [r for r in run.requests if r.done_t is not None and not r.failed
            and run.t0 <= r.done_t <= run.t1 + 1e-9 and r.tokens]


def sample(run: Run, seed: int) -> List[ReqRecord]:
    """The requests the judge compares: the longest the window finished
    (most prompt and served tokens), then others drawn from the seed,
    until ``sample.min_tokens`` served tokens or ``sample.max_requests``
    requests."""
    done = finished_in_window(run)
    if not done:
        return []
    spec = run.mix["sample"]
    longest = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    rest = [r for r in done if r is not longest]
    order = TR._rng(seed, 53).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= spec["min_tokens"] or len(out) >= spec["max_requests"]:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out
