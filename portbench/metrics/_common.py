"""Arithmetic the metric readers share: percentiles and rates over every
sample of the window (never a median of chunks), and the h2d bytes and
tokens of a window."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float):
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks); a failed request enters as +inf.  None without
    samples."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: float, seconds: float):
    return count / seconds if seconds > 0 else None


def tokens_in_window(run) -> int:
    return sum(1 for r in run.requests for t in r.token_t if run.in_window(t))


def h2d_bytes(run) -> int:
    c = run.counters
    return c["pool_h2d_bytes"] + c["prefill_h2d_bytes"]


def share(num, den):
    """100 * num / den, or None where there is nothing to read."""
    if not den or num is None:
        return None
    return 100.0 * num / den


def traced(run, key):
    """The traced slice's ``key``, or None where the profiler saw no device
    activity."""
    t = run.trace
    return None if not t else t.get(key)
