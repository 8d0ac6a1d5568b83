"""Chrome ``trace_event`` span recording (the port's own copy of the
reference's ``obs/tracing.py``: the same pids, tids and span names).

Spans are appended host-side as plain dicts (one append per event, no
formatting until export) and written as the JSON object format
``{"traceEvents": [...]}`` that ``chrome://tracing`` / Perfetto load
directly.  Two process tracks:

* ``pid=0`` **engine** — ``tid=0`` carries the per-step phase spans
  (plan / chunks / dispatch / sync / sample / host nested under each
  ``step`` span by containment), ``tid=1`` the executor dispatch detail;
* ``pid=1`` **requests** — one thread per request id, carrying that
  request's lifecycle: ``submit`` instant → ``queue_wait`` span →
  ``prefill[lo:hi)`` span per admission chunk → one ``decode`` span
  (first decode token → finish) → ``finish`` instant.  Gaps between
  prefill chunks are real: they are the steps the budget spent on other
  rows.

All timestamps come from one ``perf_counter_ns`` origin captured at
construction; ``ts``/``dur`` are microseconds as the format requires.
Spans measure *host-side dispatch-to-return* intervals: on the card a
kernel launch returns before the kernel runs, so device work shows up in
the step's ``sync`` phase (the point the engine blocks reading its
sampled tokens), never through an added device synchronization.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

PID_ENGINE = 0
PID_REQUESTS = 1
TID_STEPS = 0
TID_EXEC = 1


class Tracer:
    def __init__(self, clock_ns=time.perf_counter_ns):
        self._clock = clock_ns
        self._t0 = clock_ns()
        self.events: List[Dict[str, Any]] = []
        self._named_threads = set()
        self._named_procs = set()
        self._process_meta(PID_ENGINE, "engine")
        self._process_meta(PID_REQUESTS, "requests")
        self._thread_meta(PID_ENGINE, TID_STEPS, "engine steps")
        self._thread_meta(PID_ENGINE, TID_EXEC, "executor dispatch")

    # ------------------------------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) / 1e3

    def _process_meta(self, pid: int, name: str) -> None:
        if pid in self._named_procs:
            return
        self._named_procs.add(pid)
        self.events.append({"ph": "M", "name": "process_name",
                            "pid": pid, "tid": 0, "args": {"name": name}})

    def _thread_meta(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._named_threads:
            return
        self._named_threads.add((pid, tid))
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def request_track(self, rid: int) -> int:
        """Ensure request ``rid`` has a named thread; returns its tid."""
        self._thread_meta(PID_REQUESTS, rid, f"request {rid}")
        return rid

    # ------------------------------------------------------------------
    def complete(self, name: str, pid: int, tid: int, ts_us: float,
                 dur_us: float, args: Optional[Dict[str, Any]] = None
                 ) -> None:
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": ts_us, "dur": max(0.0, dur_us)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, pid: int, tid: int,
                ts_us: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": self.now_us() if ts_us is None else ts_us, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
