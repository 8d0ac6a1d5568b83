"""Unified telemetry plane (port of the reference's ``obs/__init__.py``):
ONE registry feeds the end-of-run summary, the ``--metrics-json``
snapshot and the Chrome trace, so no two outputs can disagree.

:class:`Telemetry` is the facade engines wire through:

* a :class:`~repro_torch.obs.registry.MetricsRegistry` (always present — even
  ``Telemetry.off()`` serves the pull-time collectors that back the
  legacy ``stats()`` shim);
* an optional :class:`~repro_torch.obs.tracing.Tracer` (``trace=True``)
  recording per-request lifecycle spans and per-step phase spans as
  Chrome ``trace_event`` JSON;
* an optional :class:`~repro_torch.obs.roofline.RooflineAccountant`
  (``timing=True``) comparing measured tokens/s and h2d bytes against
  ``core.cost_model`` predictions per step window (the ``"h100"`` row).

Hot-path contract (the reference's; held by ``tests/test_torch_obs.py``
and by ``serve_bench``'s ``telemetry_overhead`` scenario): telemetry is
host-side only.  It never touches the sampling generator, adds no device
synchronisation (no ``torch.cuda.synchronize``: the host clock reads
around asynchronous launches measure the launches, ``exec`` and the
step's ``dispatch``, and the device's work lands in ``sync``, the step's
token read; on the packed planes the per-MoE-layer routing read is a
sync inside ``exec.moe_ns``), generated tokens are bitwise identical
with telemetry on or off, and full tracing costs < 5 % decode tokens/s
on the mixed serving workload.

``jit``: the reference counts its XLA executable cache.  The port has
none; the honest counterpart is the CUDA kernel-library cache of
``kernels/build.py``: ``builds`` = the ``nvcc`` compiles in this process,
``hits`` = the ``load()`` calls served from the loaded libraries,
``entries`` = the libraries loaded.  All 0 on the CPU, where no kernel
is built.  Only its key set is comparable with the reference's.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, flatten_legacy,
                                      metrics_document, write_metrics_json)
from repro_torch.obs.roofline import RooflineAccountant
from repro_torch.obs.roofline import hardware as roofline_hardware
from repro_torch.obs.schema import EXEC_KEYS_BY_PLANE, SCHEMA_VERSION
from repro_torch.obs import tracing
from repro_torch.obs.tracing import Tracer

__all__ = ["Telemetry", "MetricsRegistry", "Tracer", "RooflineAccountant",
           "Counter", "Gauge", "Histogram", "ExecPhases", "StepTimer",
           "SpecMetrics", "flatten_legacy", "metrics_document",
           "write_metrics_json", "jit_cache_metrics", "SCHEMA_VERSION"]

_STEP_PHASES = ("plan", "chunk", "dispatch", "sync", "sample", "host")


def jit_cache_metrics() -> Dict[str, int]:
    """``jit`` namespace collector: the kernel-library cache counters of
    ``kernels/build.py`` (module docstring)."""
    from repro_torch.kernels import build
    return build.cache_stats()


class ExecPhases:
    """Executor dispatch-phase accumulator (``exec`` namespace): the
    executor calls :meth:`begin` once per step and :meth:`mark` after
    each dispatch segment; each mark adds the elapsed interval to that
    phase's counter.  Phase names are plane-specific
    (``schema.EXEC_KEYS_BY_PLANE``) so the packed pipeline's separate
    staging dispatch is measurable."""

    __slots__ = ("_counters", "_t", "_clock")

    def __init__(self, registry: MetricsRegistry, plane: str,
                 clock_ns=time.perf_counter_ns):
        self._clock = clock_ns
        self._counters = {key[:-len("_ns")]: registry.counter("exec", key)
                          for key in EXEC_KEYS_BY_PLANE[plane]}
        self._t = 0

    def begin(self) -> None:
        self._t = self._clock()

    def mark(self, phase: str) -> None:
        now = self._clock()
        self._counters[phase].add(now - self._t)
        self._t = now


class StepTimer:
    """One engine step's phase breakdown; collected by
    :meth:`Telemetry.step_end` into the ``step`` counters/histogram and
    (when tracing) into nested ``step``/phase spans."""

    __slots__ = ("t0", "marks", "_t", "_clock", "index")

    def __init__(self, index: int, clock_ns):
        self._clock = clock_ns
        self.index = index
        self.t0 = clock_ns()
        self._t = self.t0
        self.marks: List[Tuple[str, int, int]] = []  # (phase, t_start, t_end)

    def mark(self, phase: str) -> None:
        now = self._clock()
        self.marks.append((phase, self._t, now))
        self._t = now


class SpecMetrics:
    """``spec`` namespace: speculation accounting shared by both engines,
    declared on ``registry`` at wiring time (the full key set
    ``schema.SPEC_KEYS`` exists before any round runs): a ``rounds``
    counter, per-round ``proposed``/``accepted`` histograms, the
    cumulative ``acceptance_rate`` gauge, and ``bytes_h2d_per_accepted``:
    measured h2d bytes divided by the tokens the verify chunks emitted
    (0.0 with no offloaded experts).  ``rounds``, ``acceptance_rate`` and
    ``bytes_h2d_per_accepted`` read as numbers; the totals are kept
    beside them."""

    __slots__ = ("_rounds", "proposed", "accepted", "_rate", "_bytes",
                 "proposed_total", "accepted_total", "emitted_total",
                 "bytes_total")

    def __init__(self, registry: MetricsRegistry):
        self._rounds = registry.counter("spec", "rounds")
        self.proposed = registry.histogram("spec", "proposed")
        self.accepted = registry.histogram("spec", "accepted")
        self._rate = registry.gauge("spec", "acceptance_rate")
        self._bytes = registry.gauge("spec", "bytes_h2d_per_accepted")
        self._rate.set(0.0)
        self._bytes.set(0.0)
        self.proposed_total = 0
        self.accepted_total = 0
        self.emitted_total = 0
        self.bytes_total = 0.0

    @property
    def rounds(self) -> int:
        return self._rounds.value

    @property
    def acceptance_rate(self) -> float:
        return self._rate.value

    @property
    def bytes_h2d_per_accepted(self) -> float:
        return self._bytes.value

    def round(self, proposed: int, accepted: int) -> None:
        """One verify round: ``proposed`` = k_eff draft tokens offered,
        ``accepted`` = length of the matching prefix (the round emitted
        ``accepted + 1`` tokens: the prefix plus the target's own)."""
        self._rounds.add(1)
        self.proposed.observe(proposed)
        self.accepted.observe(accepted)
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)
        self.emitted_total += int(accepted) + 1
        self._rate.set(self.accepted_total / max(1, self.proposed_total))

    def add_bytes(self, bytes_h2d: float) -> None:
        """Fold measured h2d bytes into the per-emitted-token gauge."""
        self.bytes_total += float(bytes_h2d)
        self._bytes.set(self.bytes_total / max(1, self.emitted_total))


class Telemetry:
    """The facade: ``timing`` enables per-step/per-request measurement
    (+ roofline), ``trace`` additionally records Chrome trace spans.
    ``Telemetry.off()`` keeps only the pull-time registry — the zero-
    cost mode every engine owns by default so ``stats()`` always
    works."""

    def __init__(self, *, timing: bool = True, trace: bool = False,
                 roofline_hw: str = "h100", roofline_window: int = 32,
                 clock_ns=time.perf_counter_ns):
        self.registry = MetricsRegistry()
        self.timing = timing
        self.clock_ns = clock_ns
        self.tracer: Optional[Tracer] = Tracer(clock_ns) if trace else None
        self.roofline: Optional[RooflineAccountant] = None
        roofline_hardware(roofline_hw)  # an unmeasured row fails here
        self.roofline_hw = roofline_hw
        self.roofline_window = roofline_window
        self._step: Dict[str, Any] = {}
        self._req: Dict[str, Any] = {}
        self._req_ts: Dict[int, Dict[str, float]] = {}

    @classmethod
    def off(cls) -> "Telemetry":
        return cls(timing=False, trace=False)

    # ------------------------------------------------------------------
    # schema declaration (engines call at wiring time so snapshots carry
    # the full key set even before any step ran)
    def declare_step_schema(self) -> None:
        r = self.registry
        self._step = {"timed": r.counter("step", "timed"),
                      "wall_ms": r.histogram("step", "wall_ms")}
        for p in _STEP_PHASES:
            self._step[p] = r.counter("step", f"{p}_ns")

    def declare_request_schema(self) -> None:
        r = self.registry
        self._req = {"submitted": r.counter("request", "submitted"),
                     "finished": r.counter("request", "finished"),
                     "queue_wait_steps": r.histogram("request",
                                                     "queue_wait_steps"),
                     "gen_tokens": r.histogram("request", "gen_tokens")}

    def attach_roofline(self, cfg, *, expert_bits: int = 16,
                        attn_bits: int = 16, expert_bytes: float = 0.0,
                        h2d_counts_fn=None) -> None:
        self.roofline = RooflineAccountant(
            self.registry, cfg, hw=self.roofline_hw,
            window=self.roofline_window, expert_bits=expert_bits,
            attn_bits=attn_bits, expert_bytes=expert_bytes,
            h2d_counts_fn=h2d_counts_fn)

    def exec_observer(self, plane: str) -> Optional[ExecPhases]:
        if not self.timing:
            return None
        return ExecPhases(self.registry, plane, self.clock_ns)

    # ------------------------------------------------------------------
    # per-step phases
    def step_begin(self, index: int) -> Optional[StepTimer]:
        if not self.timing:
            return None
        return StepTimer(index, self.clock_ns)

    def step_end(self, st: Optional[StepTimer], *, n_decode: int = 0,
                 n_chunks: int = 0, context_len: float = 0.0) -> None:
        if st is None:
            return
        end = st.marks[-1][2] if st.marks else st._t
        wall_ns = end - st.t0
        self._step["timed"].add(1)
        self._step["wall_ms"].observe(wall_ns / 1e6)
        for phase, t_lo, t_hi in st.marks:
            self._step[phase].add(t_hi - t_lo)
        if self.tracer is not None:
            tr = self.tracer
            base = tr._t0
            tr.complete(f"step {st.index}", tracing.PID_ENGINE,
                        tracing.TID_STEPS, (st.t0 - base) / 1e3,
                        wall_ns / 1e3,
                        args={"decode_rows": n_decode, "chunks": n_chunks})
            for phase, t_lo, t_hi in st.marks:
                if t_hi > t_lo:
                    tr.complete(phase, tracing.PID_ENGINE,
                                tracing.TID_STEPS, (t_lo - base) / 1e3,
                                (t_hi - t_lo) / 1e3)
        if self.roofline is not None and n_decode:
            self.roofline.step(n_decode, wall_ns, context_len)

    def trace_step(self, index: int, t0_ns: int) -> None:
        """A ``step {index}`` span from ``t0_ns`` to now on the engine's
        step track, in the trace only (the batch-1 ``OffloadEngine``'s
        decode steps, which feed no ``step`` namespace; the reference's
        engine writes none, so its traces fail the schema tool's
        per-step check)."""
        if self.tracer is None:
            return
        now = self.clock_ns()
        self.tracer.complete(f"step {index}", tracing.PID_ENGINE,
                             tracing.TID_STEPS,
                             (t0_ns - self.tracer._t0) / 1e3,
                             (now - t0_ns) / 1e3)

    # ------------------------------------------------------------------
    # request lifecycle
    def req_submitted(self, rid: int, step: int) -> None:
        if not self.timing:
            return
        self._req["submitted"].add(1)
        ts = {"submit": self.clock_ns()}
        self._req_ts[rid] = ts
        if self.tracer is not None:
            tid = self.tracer.request_track(rid)
            self.tracer.instant("submit", tracing.PID_REQUESTS, tid,
                                args={"step": step})

    def req_admitted(self, rid: int, waited_steps: int) -> None:
        if not self.timing:
            return
        self._req["queue_wait_steps"].observe(waited_steps)
        now = self.clock_ns()
        ts = self._req_ts.setdefault(rid, {"submit": now})
        ts["admitted"] = now
        if self.tracer is not None:
            tid = self.tracer.request_track(rid)
            base = self.tracer._t0
            self.tracer.complete(
                "queue_wait", tracing.PID_REQUESTS, tid,
                (ts["submit"] - base) / 1e3, (now - ts["submit"]) / 1e3,
                args={"steps": waited_steps})

    def req_chunk(self, rid: int, lo: int, hi: int, t0_ns: int) -> None:
        if self.tracer is None:
            return
        now = self.clock_ns()
        tid = self.tracer.request_track(rid)
        base = self.tracer._t0
        self.tracer.complete(f"prefill[{lo}:{hi})", tracing.PID_REQUESTS,
                             tid, (t0_ns - base) / 1e3, (now - t0_ns) / 1e3,
                             args={"tokens": hi - lo})

    def req_decode_start(self, rid: int) -> None:
        if not self.timing:
            return
        ts = self._req_ts.get(rid)
        if ts is not None and "decode" not in ts:
            ts["decode"] = self.clock_ns()

    def req_finished(self, rid: int, n_tokens: int, reason: str) -> None:
        if not self.timing:
            return
        self._req["finished"].add(1)
        self._req["gen_tokens"].observe(n_tokens)
        ts = self._req_ts.pop(rid, None)
        if self.tracer is None or ts is None:
            return
        now = self.clock_ns()
        tid = self.tracer.request_track(rid)
        base = self.tracer._t0
        t_dec = ts.get("decode", now)
        self.tracer.complete("decode", tracing.PID_REQUESTS, tid,
                             (t_dec - base) / 1e3, (now - t_dec) / 1e3,
                             args={"tokens": n_tokens, "reason": reason})
        self.tracer.instant("finish", tracing.PID_REQUESTS, tid,
                            args={"tokens": n_tokens, "reason": reason})

    # ------------------------------------------------------------------
    # outputs — all three views read the SAME registry
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        if self.roofline is not None:
            self.roofline.flush()  # short runs still report a window
        return self.registry.snapshot()

    def legacy_flat(self) -> Dict[str, Any]:
        return flatten_legacy(self.snapshot())

    def write_metrics(self, path, mode: Optional[Dict[str, Any]] = None
                      ) -> None:
        write_metrics_json(path, self.snapshot(), mode)

    def write_trace(self, path) -> None:
        assert self.tracer is not None, \
            "trace output needs Telemetry(trace=True)"
        self.tracer.write(path)
