"""The benchmark's own spans, and the reduction of a profiler trace.

In a ``--trace 1`` run the harness wraps the calls into the layers it
measures with ``torch.profiler.record_function`` ranges: the engine's
step, the executor's decode and prompt-chunk calls, the pool's
``acquire`` and the five kernel bindings of ``kernels.ops``.  Each
binding call is put in a kernel group (the ragged binding's by whether
it attends for a prompt chunk or for decode rows), and adds the call's
bound, from the frozen work functions over the call's shapes, to its
group.  A group's device time is that of the kernels whose runtime
launch (matched to the kernel by the profiler's correlation id) lies
inside one of its calls' ranges on the host: a range's own device time
misses kernels launched through ctypes.

The profiler runs over a slice of the measured window, and
:meth:`Tracer.summary` reduces it: the device's busy time (the union of
every kernel, copy and fill), the kernels' busy time, the time a
host-to-device copy was in flight, kernel launches, the bound and device
time of each kernel group, the model operations of every token
processed, the device operations that took most time, and the idle gaps
by the host range they fell in.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch

from portbench import work as WK

BINDINGS = ("dequant_matmul_slots", "dequant_matmul_batched",
            "dequant_matmul", "flash_attention", "ragged_attention")
# a binding call -> its kernel group; the ragged binding's by its query rows
GROUPS = {"dequant_matmul_slots": "gemv", "dequant_matmul_batched": "grouped",
          "dequant_matmul": "dequant_2d", "flash_attention": "flash"}


def union_us(spans) -> float:
    return sum(b - a for a, b in merged(spans))


def merged(spans):
    out = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_h2d(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


class Tracer:
    """Spans and work accounting of one traced run (module docstring).
    ``cfg`` is the configuration file's dict; ``h2d_now`` returns the
    h2d bytes the program has issued so far."""

    def __init__(self, cfg: dict, h2d_now: Callable[[], int]):
        self.cfg = cfg
        self.h2d_now = h2d_now
        self.heads = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                      cfg["head_dim"])
        self.window = cfg.get("sliding_window")
        self.on = False
        self.prof = None
        self.labels = set()
        self._undo = []
        self._records = None
        self._paged = None
        self.reset()

    def reset(self):
        self.bound_ms = defaultdict(float)
        self.calls = defaultdict(int)
        self.tokens = 0
        self.pairs = 0
        self.steps = 0

    # ------------------------------------------------------------------
    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        had = name in getattr(owner, "__dict__", {})
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig, had))

    def _range(self, label, fn, account=None):
        self.labels.add(label)

        def wrapped(*a, **kw):
            if account is not None and self.on:
                account(*a, **kw)
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    def _binding(self, name, fn):
        """A kernel binding's wrapper: the call's group and bound, then the
        call inside a ``kernel.<group>`` range."""
        def wrapped(*a, **kw):
            group = self._group(name, *a, **kw)
            label = f"kernel.{group}"
            self.labels.add(label)
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        # a binding counts its launches on the module attribute that names
        # it, which is now this wrapper
        wrapped.launches = fn.launches
        return wrapped

    def install(self, executor) -> None:
        """Wrap the executor's entry points, the pool's acquire, the paged
        step's preparation and the kernel bindings."""
        from repro_torch.core import expert_pool as EP
        from repro_torch.kernels import ops
        from repro_torch.models import layers as L

        for b in BINDINGS:
            self._patch(ops, b, lambda f, b=b: self._binding(b, f))
        self._patch(EP, "acquire", lambda f: self._range(
            "pool.acquire", f, self._acquire))
        self._patch(L, "paged_step", lambda f: self._paged_step(f))
        self._patch(executor, "decode", lambda f: self._range(
            "executor.decode", f, self._decode))
        self._patch(executor, "prefill_chunk", lambda f: self._range(
            "executor.prefill_chunk", f, self._chunk))
        self._patch(executor, "prefill_chunk_row", lambda f: self._range(
            "executor.prefill_chunk_row", f, self._chunk_row))

    def uninstall(self) -> None:
        for owner, name, orig, had in reversed(self._undo):
            if hasattr(orig, "launches"):
                orig.launches = getattr(owner, name).launches
            if had:
                setattr(owner, name, orig)
            else:  # an instance's method: drop the instance attribute
                delattr(owner, name)
        self._undo.clear()

    def span(self, label: str):
        self.labels.add(label)
        return torch.profiler.record_function(label)

    # -- work accounting (host side, from shapes and host arrays) -------
    def _group(self, binding, *a, **kw) -> str:
        """The call's kernel group; adds its bound while the slice runs."""
        if binding == "ragged_attention":
            C = a[0].shape[1]  # q (B, C, H, hd)
            group = "ragged_prefill" if C > 1 else "ragged_decode"
            if not self.on or self._paged is None:
                return group
            pos, C, ps = self._paged
            work = WK.ragged_work(pos, C, self.heads, kw.get("window"), ps,
                                  a[0].element_size())
        else:
            group = GROUPS[binding]
            if not self.on:
                return group
            if binding == "flash_attention":
                q, k = a[0], a[1]
                B, H, Sq, hd = q.shape
                work = WK.flash_work(Sq, k.shape[2], int(kw.get("q_offset", 0)),
                                     kw.get("window"), H, k.shape[1], hd,
                                     kw.get("causal", True), B, q.element_size())
            else:
                x, qt = a[0], a[1]
                K, N = qt.shape[-2:]
                if binding == "dequant_matmul_batched":
                    offsets = a[2] if len(a) > 2 else kw.get("offsets")
                    if offsets is None:
                        rows, records = x.shape[0] * x.shape[1], x.shape[0]
                    else:
                        rows, records = int(offsets[-1]), len(offsets) - 1
                elif binding == "dequant_matmul_slots":
                    rows = x.shape[0] * x.shape[1]
                    records = self._records if self._records is not None else rows
                else:
                    rows, records = x.shape[0], 1
                work = WK.dequant_work(rows, K, N, qt.bits, records,
                                       x.element_size(), qt.group_size)
        self.bound_ms[group] += WK.bound(*work)[0]
        self.calls[group] += 1
        return group

    def _acquire(self, store, st, l, ids, active=None, *a, **kw):
        ids = np.asarray(ids)
        if active is not None:
            ids = ids[np.asarray(active, bool)]
        self._records = len(np.unique(ids))

    def _paged_step(self, fn):
        def wrapped(pos, pages, active, C, page_size, *a, **kw):
            p = np.asarray(pos).reshape(-1)
            if active is not None:
                p = p[np.asarray(active, bool)]
            self._paged = (p, int(C), int(page_size))
            return fn(pos, pages, active, C, page_size, *a, **kw)
        return wrapped

    def _count(self, pos, C):
        for p in np.asarray(pos).reshape(-1):
            self.tokens += C
            self.pairs += WK.visible_pairs(int(p), C, self.window)

    def _decode(self, state, tokens, pstate=None, active=None, **kw):
        B, C = tokens.shape
        pos = np.broadcast_to(np.asarray(state["pos"]), (B,))
        if active is not None:
            pos = pos[np.asarray(active, bool)]
        self._count(pos, int(C))

    def _chunk(self, state, tokens):
        B, C = tokens.shape
        self._count(np.broadcast_to(np.asarray(state["pos"]), (B,)), int(C))

    def _chunk_row(self, state, tokens, slot):
        self._count(np.asarray(state["pos"])[slot: slot + 1], int(tokens.shape[1]))

    # -- the profiled slice ---------------------------------------------
    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        self.reset()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.h2d0 = self.h2d_now()
        self.t0 = time.perf_counter()
        self.on = True

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.h2d1 = self.h2d_now()
        self.on = False
        self.prof.stop()

    def step(self) -> None:
        if self.on:
            self.steps += 1

    def summary(self) -> Dict[str, object]:
        """The reduction of the profiled slice (module docstring); device
        entries None where the profiler saw no device activity."""
        from torch.autograd import DeviceType
        evs = list(self.prof.events())
        window_s = self.t1 - self.t0
        cpu = [e for e in evs if e.device_type == DeviceType.CPU]
        dev = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.name not in self.labels]
        out = {"window_s": window_s, "steps": self.steps,
               "tokens": self.tokens, "pairs": self.pairs,
               "h2d_bytes": self.h2d1 - self.h2d0,
               "bound_ms": dict(self.bound_ms), "calls": dict(self.calls),
               "busy_s": None, "kernel_busy_s": None, "h2d_busy_s": None,
               "launches": None, "device_ms": {}, "device_ops": [],
               "idle_gaps": []}
        if not dev:
            return out
        span = lambda e: (e.time_range.start, e.time_range.end)
        kernels = [e for e in dev if not is_copy(e.name)]
        out["busy_s"] = union_us(map(span, dev)) / 1e6
        out["kernel_busy_s"] = union_us(map(span, kernels)) / 1e6
        out["h2d_busy_s"] = union_us(span(e) for e in dev if is_h2d(e.name)) / 1e6
        out["launches"] = len(kernels)
        # a group's device time: the kernels whose launch (the runtime call,
        # matched by correlation id) lies inside one of its calls' ranges
        device_ms = defaultdict(float)
        launch = {e.id: e for e in cpu if "Launch" in e.name}
        ranges = sorted((e.time_range.start, e.time_range.end, e.name[7:])
                        for e in cpu if e.name.startswith("kernel."))
        starts = [r[0] for r in ranges]
        matched = 0
        for k in kernels:
            rt = launch.get(k.id)
            if rt is None:
                continue
            matched += 1
            t = rt.time_range.start
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
                device_ms[ranges[i][2]] += (k.time_range.end - k.time_range.start) / 1e3
        out["kernels_matched"] = matched
        out["device_ms"] = dict(device_ms)
        by_name = defaultdict(float)
        for e in dev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        out["device_ops"] = [[n[:120], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        # idle gaps on the device (no kernel, copy or fill), each labelled by
        # the innermost of the benchmark's host ranges open when it began
        # (the host ranges nest, so a stack swept along time holds the
        # innermost open one on top)
        host = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in cpu if e.name in self.labels)
        busy = merged(map(span, dev))
        gaps = defaultdict(float)
        stack, i = [], 0
        for (_, a1), (b0, _) in zip(busy[:-1], busy[1:]):
            while i < len(host) and host[i][0] <= a1:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= a1:
                stack.pop()
            gaps[stack[-1][2] if stack else "outside the ranges"] += (b0 - a1) / 1e6
        out["idle_gaps"] = [[n, s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:10]]
        return out
