"""Dependency-free metrics registry: counters, gauges, log-bucketed
histograms, and pull-time collectors (the port's own copy of the
reference's ``obs/registry.py``).

Two kinds of metric feed one namespaced snapshot:

* **declared** metrics — :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` objects created up front (so a schema's key set
  never depends on which code paths happened to fire) and updated inline
  on the hot path.  Updates are plain attribute arithmetic — no locks,
  no allocation for counters/gauges, O(1) bucket math for histograms.
* **collectors** — callables registered per namespace and invoked only
  at :meth:`MetricsRegistry.snapshot` time, for state that already lives
  elsewhere (KV occupancy tables, expert-pool counters, the kernel
  cache).  Pull-based collection is what keeps telemetry off the decode
  hot path.

A namespace's declared keys and collector keys must be disjoint
(asserted at snapshot), so the same metric can never be reported from
two sources with two values.
"""
from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, Optional


class Counter:
    """Monotonic accumulator (float or int)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, v=1) -> None:
        self.value += v


class Gauge:
    """Last-write-wins point value (numbers or short strings)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Log2-bucketed histogram of non-negative samples.

    ``observe`` costs one ``frexp`` plus a dict increment; the snapshot
    reports count/sum/min/max plus bucket-interpolated p50/p95 (each
    bucket spans one power of two, so quantile estimates are within 2x —
    good enough for latency triage; exact tails come from the trace).
    """

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # bucket b holds samples in [2**(b-1), 2**b); b=None→0 for v<=0
        b = math.frexp(v)[1] if v > 0 else 0
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def _quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for b in sorted(self.buckets):
            n = self.buckets[b]
            if seen + n >= target:
                lo = 0.0 if b <= 0 else float(2 ** (b - 1))
                hi = float(2 ** b)
                frac = (target - seen) / n
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            seen += n
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "buckets": {}}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self._quantile(0.5), "p95": self._quantile(0.95),
                "buckets": {str(k): v for k, v in
                            sorted(self.buckets.items())}}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Namespaced metric store: ``(namespace, key) -> metric``, plus
    per-namespace pull-time collectors."""

    def __init__(self):
        self._metrics: Dict[str, Dict[str, Any]] = {}
        self._kinds: Dict[tuple, str] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, Any]]] = {}

    # ------------------------------------------------------------------
    def _declare(self, kind: str, ns: str, key: str):
        space = self._metrics.setdefault(ns, {})
        if key in space:
            have = self._kinds[(ns, key)]
            if have != kind:
                raise ValueError(f"{ns}.{key} already declared as {have}")
            return space[key]
        m = _KINDS[kind]()
        space[key] = m
        self._kinds[(ns, key)] = kind
        return m

    def counter(self, ns: str, key: str) -> Counter:
        return self._declare("counter", ns, key)

    def gauge(self, ns: str, key: str) -> Gauge:
        return self._declare("gauge", ns, key)

    def histogram(self, ns: str, key: str) -> Histogram:
        return self._declare("histogram", ns, key)

    def register_collector(self, ns: str,
                           fn: Callable[[], Dict[str, Any]]) -> None:
        """Register (or replace — last attached engine wins) the pull
        source for namespace ``ns``."""
        self._collectors[ns] = fn

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Nested ``{namespace: {key: value}}`` view: declared metric
        values merged with freshly-pulled collector output."""
        out: Dict[str, Dict[str, Any]] = {}
        for ns, space in self._metrics.items():
            out[ns] = {k: (m.snapshot() if isinstance(m, Histogram)
                           else m.value) for k, m in space.items()}
        for ns, fn in self._collectors.items():
            collected = fn()
            space = out.setdefault(ns, {})
            overlap = set(space) & set(collected)
            assert not overlap, \
                f"namespace {ns!r}: declared and collected keys overlap " \
                f"({sorted(overlap)})"
            space.update(collected)
        return out


# ----------------------------------------------------------------------
_LEGACY_PREFIX = {"engine": "", "kv": "kv_", "offload": "offload_"}


def flatten_legacy(snapshot: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Project a namespaced snapshot onto the legacy flat ``stats()``
    dict: ``engine.steps`` → ``steps``, ``kv.pages_free`` →
    ``kv_pages_free``, ``offload.bytes_h2d`` → ``offload_bytes_h2d``,
    anything else → ``<ns>_<key>``.  Namespaces map through disjoint
    prefixes, so a collision means a schema bug — asserted, not papered
    over."""
    flat: Dict[str, Any] = {}
    for ns, space in snapshot.items():
        prefix = _LEGACY_PREFIX.get(ns, f"{ns}_")
        for key, val in space.items():
            name = f"{prefix}{key}"
            assert name not in flat, \
                f"legacy flattening collision on {name!r} (from {ns}.{key})"
            flat[name] = val
    return flat


def _sanitize(obj):
    """Make a snapshot JSON-serializable: numpy scalars → python,
    arrays/tuples → lists, non-finite floats → None, unknown objects →
    repr (metrics files must never fail to write because a collector
    leaked an exotic value)."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, (int, float)):
        if isinstance(obj, float) and not math.isfinite(obj):
            return None
        return obj
    if hasattr(obj, "item") and not getattr(obj, "ndim", 0):
        return _sanitize(obj.item())
    if hasattr(obj, "tolist"):
        return _sanitize(obj.tolist())
    return repr(obj)


def metrics_document(snapshot: Dict[str, Dict[str, Any]],
                     mode: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The ``--metrics-json`` file layout (validated by
    ``tools/check_metrics_schema.py``)."""
    from repro_torch.obs.schema import SCHEMA_VERSION
    return {"schema_version": SCHEMA_VERSION,
            "mode": _sanitize(mode or {}),
            "metrics": _sanitize(snapshot)}


def write_metrics_json(path, snapshot, mode=None) -> None:
    doc = metrics_document(snapshot, mode)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
