"""Roofline analysis of one step by counting the ops torch dispatches:
the port of the reference's ``launch/roofline.py``.

The reference parses XLA's compiled, per-device HLO.  Torch has no such
input, so :func:`analyze_step` runs the step under a dispatch mode
(:class:`CountMode`) that sees every op one rank runs, on its local
shards: a DTensor op is let through to DTensor's own dispatch, which
redistributes (issuing the functional collectives) and then runs the op
on the local tensors, and those ops and collectives are what is counted.
Replicated work counts once per rank, as in XLA's per-device HLO.

* FLOPs: the matmul and convolution ops (``torch.utils.flop_counter``'s
  formulas) on the local shapes;
* bytes: operands + output of the op classes that would stay
  memory-moving after fusion (:data:`COUNT_BYTE_OPS`, the counterpart of
  the reference's list): matmuls, copies (a transpose made contiguous is
  a copy), index / gather / scatter, cat, pad, reductions and sorts;
  bare elementwise ops are skipped;
* collective bytes: per functional collective, the reference's ring
  model of bytes moved per rank: all-gather and reduce-scatter
  out·(g−1)/g, all-reduce twice that, all-to-all out·(g−1)/g as in the
  reference's code (its docstring says "as-is"), permutes as they are.

The reference scales ``while`` bodies by their trip count; the dry-run
(launch/dryrun.py) counts the step at one and at two periods of the
block pattern (and one and two microbatches) and extrapolates linearly
(:func:`extrapolate`).  Within a step, a loop over ``meta`` tensors
(shapes only, so every step runs the same ops) may run its body once
under :func:`repeat`, counted as its trip count of bodies (the sLSTM
position loop and the mLSTM chunk loop of ``models/recurrent``).  The
reference's HLO helpers (``parse_hlo``,
``_parse_shape``, ``_parse_dims``, ``_multipliers``, ``_trip_count``,
``_group_size``, ``_dot_flops``, ``xla_cost_analysis``) read XLA's text
and are JAX-only; this module is their counting counterpart.  What it
cannot see: a compiler's schedule (what overlaps), and the traffic of a
fused op, which torch's eager ops over-count.

Hardware constants: the port's ``h100`` row (NVIDIA H100 SXM data sheet):
989e12 FLOP/s dense bf16, 3.35e12 B/s HBM3.  The collective bandwidth,
50e9 B/s per GPU, is the data sheet of NDR InfiniBand (400 Gb/s per GPU):
every 16-wide mesh axis leaves an 8-GPU NVLink node.  None of the three
is a measurement.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # bf16 dense / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12     # bytes/s / GPU (H100 SXM data sheet)
COLL_BW = 50e9       # bytes/s / GPU, NDR InfiniBand (data sheet)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
}

# the op classes whose operand + output bytes count as HBM traffic
COUNT_BYTE_OPS = {
    # matmuls / convolutions
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
    # copies (a transpose or a view made contiguous is one)
    "copy_", "_to_copy", "clone", "contiguous",
    # index / gather / scatter
    "index", "index_put", "index_put_", "_index_put_impl_", "index_select",
    "index_add", "index_add_", "index_copy", "index_copy_", "gather",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "embedding", "embedding_dense_backward", "take_along_dim",
    # cat / pad
    "cat", "stack", "constant_pad_nd",
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "norm", "var_mean", "argmax",
    # sorts
    "sort", "topk",
}


# the factor every count is multiplied by (:func:`repeat`): a process-wide
# stack, as the backward pass runs on the autograd engine's threads
_SCALE = [1]


@contextlib.contextmanager
def repeat(n: int):
    """Count whatever runs inside as ``n`` runs of it (0: not at all), the
    counterpart of the reference's trip-count scaling of a ``while``
    body whose body runs once here.  Nests by multiplying."""
    _SCALE.append(_SCALE[-1] * n)
    try:
        yield
    finally:
        _SCALE.pop()


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0.0


def _group_size(args) -> int:
    """The group size of a functional collective from its group name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[-1]
    try:
        return _resolve_process_group(group).size()
    except Exception:
        return int(args[1]) if len(args) > 2 and isinstance(args[1], int) \
            else 1


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Effective bytes one rank moves for a collective whose output is
    ``out_bytes``, in a group of ``g`` (the reference's ring model)."""
    if kind == "collective-permute":
        return out_bytes
    eff = out_bytes * (g - 1) / max(g, 1)
    return 2.0 * eff if kind == "all-reduce" else eff


_SKIP = ("/repro_torch/sharding/", "/repro_torch/launch/")


def caller_label() -> str:
    """``module.function`` of the innermost port frame outside the
    sharding and launch layers (the counterpart of jax's ``op_name``)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in fn and not any(s in fn for s in _SKIP):
            mod = fn.rsplit("/", 1)[-1][:-3]
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


@dataclass
class OpRecord:
    kind: str          # "collective" or "memory"
    op: str
    bytes: float
    shape: str
    group: int
    label: str


class CountMode(TorchDispatchMode):
    """Counts one rank's flops, HBM bytes and collective bytes of what
    runs under it (see the module docstring); ``record`` keeps each
    collective and memory op with its issuing port function."""

    def __init__(self, record: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.record = record
        self.rep = RooflineReport()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first; its local ops come back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation at global shapes
        n = _SCALE[-1]
        if not n:
            return out
        name = func._overloadpacket.__name__
        packet = func._overloadpacket
        if packet in self.registry:
            f = float(self.registry[packet](*args, **kwargs, out_val=out))
            self.rep.flops += n * f
        coll = _COLL_OPS.get(name) if func.namespace in (
            "_c10d_functional", "_c10d_functional_autograd", "c10d") else None
        if coll is not None:
            g = _group_size(args)
            eff = n * ring_bytes(coll, _nbytes(out), g)
            self.rep.coll_bytes += eff
            self.rep.coll_by_type[coll] = self.rep.coll_by_type.get(coll, 0.0) \
                + eff
            self.rep.coll_count += n
            if self.record:
                self.ops.append(OpRecord("collective", coll, eff,
                                         _shape(out), g, caller_label()))
        elif name in COUNT_BYTE_OPS:
            b = _nbytes(out) + sum(_nbytes(a) for a in args)
            self.rep.hbm_bytes += n * b
            if self.record:
                self.ops.append(OpRecord("memory", name, n * _nbytes(out),
                                         _shape(out), 1, caller_label()))
        return out


def _shape(out) -> str:
    t = out[0] if isinstance(out, (list, tuple)) and out else out
    if not isinstance(t, torch.Tensor):
        return ""
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


@dataclass
class RooflineReport:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_type: Dict[str, float] = field(default_factory=dict)
    coll_count: int = 0
    unscaled_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / COLL_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "collective_by_type": self.coll_by_type,
            "collective_op_count": self.coll_count,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def analyze_step(fn, *args, n_devices: int = 1, record: bool = False,
                 **kwargs):
    """Run ``fn(*args, **kwargs)`` once under :class:`CountMode`; returns
    (its output, the :class:`RooflineReport` of one rank, the recorded
    ops).  ``n_devices`` is the mesh size the counts are per rank of."""
    del n_devices  # the counts are already one rank's
    with CountMode(record=record) as mode:
        out = fn(*args, **kwargs)
    mode.rep.unscaled_flops = mode.rep.flops
    return out, mode.rep, mode.ops


def extrapolate(reports: Dict[tuple, RooflineReport], n_periods: int,
                micro: int = 1) -> RooflineReport:
    """The report of ``n_periods`` periods and ``micro`` microbatches from
    reports counted at (1, 1), (2, 1) and, when ``micro > 1``, (1, 2) and
    (2, 2) (periods, microbatches): exact for a cost bilinear in the two
    (the reference's trip-count scaling of its ``while`` bodies)."""
    keys = {"flops", "hbm_bytes", "coll_bytes", "coll_count"}
    types = set()
    for r in reports.values():
        types |= set(r.coll_by_type)

    def get(r, k):
        return r.coll_by_type.get(k[5:], 0.0) if k.startswith("type:") \
            else getattr(r, k)

    def at(k):
        a = get(reports[(1, 1)], k)
        dp = get(reports[(2, 1)], k) - a
        if micro == 1 or (1, 2) not in reports:
            return a + (n_periods - 1) * dp
        dm = get(reports[(1, 2)], k) - a
        dpm = get(reports[(2, 2)], k) - a - dp - dm
        return a + (n_periods - 1) * dp + (micro - 1) * dm \
            + (n_periods - 1) * (micro - 1) * dpm

    out = RooflineReport()
    for k in keys:
        setattr(out, k, at(k))
    out.coll_count = int(round(out.coll_count))
    out.coll_by_type = {t: at("type:" + t) for t in sorted(types)}
    out.unscaled_flops = reports[(1, 1)].flops
    return out


def model_flops(cfg, n_tokens: int, kind: str = "train") -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); bwd counted for train only."""
    from repro_torch.models.transformer import count_params_analytic

    n = count_params_analytic(cfg)
    n -= cfg.vocab_size * cfg.d_model  # embeddings are lookups
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = (cfg.moe_layer_count * (cfg.moe.num_experts - cfg.moe.top_k)
                    * per_expert)
        n -= inactive
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens


def top_ops(ops: List[OpRecord], top: int = 15):
    """(collectives, memory ops), each sorted by bytes, largest first."""
    colls = sorted((o for o in ops if o.kind == "collective"),
                   key=lambda o: -o.bytes)
    mems = sorted((o for o in ops if o.kind == "memory"),
                  key=lambda o: -o.bytes)
    return colls[:top], mems[:top]


__all__ = ["PEAK_FLOPS", "HBM_BW", "COLL_BW", "COLLECTIVES",
           "COUNT_BYTE_OPS", "CountMode", "RooflineReport", "analyze_step",
           "extrapolate", "model_flops", "repeat", "ring_bytes", "top_ops"]
