"""Logical-axis sharding rules (FSDP + tensor parallel + expert parallel)
on ``torch.distributed``: the port of the reference's
``sharding/specs.py``.

The production mesh is a ``DeviceMesh`` with dims ``("data", "model")``
single-pod or ``("pod", "data", "model")`` multi-pod (launch/mesh.py).
Policy, as in the reference:

* **batch** -> ``("pod", "data")`` (dropped when the global batch is not
  divisible, e.g. long_500k B=1);
* **tensor parallel** -> ``"model"`` on attention head axes / FFN hidden /
  expert hidden, guarded by divisibility (smollm's 15 heads and qwen's 20
  heads do not TP on a 16-way axis; their FFN still does);
* **FSDP** -> parameters additionally sharded on ``"data"`` (and
  ``"pod"``) along a non-TP axis;
* **expert parallel** -> expert axis on ``"model"`` when
  ``num_experts % model_size == 0`` (granite: 32 % 16 = 0); otherwise
  experts are tensor-parallel over their hidden dim (mixtral: 8 experts
  on a 16-way axis).

A spec is a :class:`Spec`, a tuple of one entry per tensor dim (None, a
mesh-dim name, or a tuple of names), as the reference's
``PartitionSpec``, so spec trees compare with ``==`` against the
reference's.  :func:`placements` turns a spec into DTensor placements
and :func:`named` a tree of specs into a tree of placements (the
reference's ``NamedSharding`` tree).  A dim sharded over several mesh
dims is split in **mesh order**: ``("data", "pod")`` on the 2x16x16 mesh
puts rank (p, d) on chunk ``p * 16 + d`` where the reference's XLA puts
it on ``d * 2 + p``.  The per-rank shapes and bytes are the same; which
slice a rank holds is not.

The port's parameter tree is per layer (``params["layers"][l]``, no
leading period axis), so :func:`param_spec_tree` gives each layer the
reference's spec of ``stack[l % period]`` without its leading ``None``
(tail layers and the encoder's layers alike); :func:`decode_state_spec_tree`
does the same for the per-layer decode state.

``constrain`` is the mesh-aware sharding constraint: it returns ``x``
unchanged unless a mesh is current (:func:`mesh_context`) and ``x`` is a
DTensor, drops axes that are absent or do not divide the dim, and
otherwise redistributes, so model code states intent unconditionally.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

# the current mesh: a process-wide stack, not a context variable, so that
# the backward pass (which runs on the autograd engine's device threads)
# sees the mesh its forward ran under
_MESH: list = []


class Spec(tuple):
    """A partition spec: one entry per tensor dim (None, a mesh-dim name
    or a tuple of them; a 1-tuple is its one name, as in ``PartitionSpec``).
    ``Spec(None, "model") == (None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def mesh_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh_names(mesh), mesh.mesh.shape))


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` as the current mesh (torch has no ambient mesh;
    :func:`constrain` reads this one)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    return _MESH[-1] if _MESH else None


def _filter_spec(mesh, shape, spec_entries):
    """Keep only axes present in the mesh and dividing the dim size."""
    names, sizes = mesh_names(mesh), mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        size = 1
        for ax in axes:
            if ax in names:
                kept.append(ax)
                size *= sizes[ax]
        if kept and dim % size == 0:
            out.append(tuple(kept) if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    return Spec(*out)


_DTENSOR = []


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def constrain(x, *spec_entries):
    """Redistribute the DTensor ``x`` to ``spec_entries`` (filtered on the
    current mesh); ``x`` itself outside a mesh or when it is a plain
    tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    entries = list(spec_entries) + [None] * (x.ndim - len(spec_entries))
    spec = _filter_spec(mesh, x.shape, entries[: x.ndim])
    target = placements(mesh, spec)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def placements(mesh, spec):
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d names that mesh dim, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def spec_placements(mesh, shape, entries):
    """Placements of a tensor of ``shape`` under spec ``entries`` (padded
    with None, filtered as :func:`constrain` filters them)."""
    entries = list(entries) + [None] * (len(shape) - len(entries))
    return placements(mesh, _filter_spec(mesh, shape, entries[: len(shape)]))


def local_shape(mesh, shape, spec) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        div = math.prod(sizes[a] for a in axes)
        assert n % div == 0, (shape, spec)
        out.append(n // div)
    return tuple(out)


# ----------------------------------------------------------------------
# Parameter / activation spec construction (used by the launchers).
def batch_spec(mesh, global_batch: int):
    """Spec entry for the batch axis: ("pod","data") when divisible."""
    names, sizes = mesh_names(mesh), mesh_shape(mesh)
    axes = [ax for ax in ("pod", "data") if ax in names]
    size = 1
    for ax in axes:
        size *= sizes[ax]
    if axes and global_batch % size == 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    return None


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _tp(mesh, dim: int) -> Optional[str]:
    return "model" if dim % mesh_axis_size(mesh, "model") == 0 else None


def _fsdp(mesh, dim: int):
    """FSDP axis for parameters/optimizer state: all batch-parallel axes
    (ZeRO shards over every data rank, pods included)."""
    axes = tuple(ax for ax in ("data", "pod") if ax in mesh_names(mesh))
    size = 1
    for ax in axes:
        size *= mesh_axis_size(mesh, ax)
    if axes and dim % size == 0:
        return axes if len(axes) > 1 else axes[0]
    if dim % mesh_axis_size(mesh, "data") == 0:
        return "data"
    return None


def _shape_of(leaf):
    """A leaf's shape: a tensor's, or the shape of a ``(shape, dtype)``
    pair of ``transformer.param_specs``; () for a Python scalar."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and len(leaf) == 2 \
            and isinstance(leaf[1], torch.dtype):
        return tuple(leaf[0])
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return ()


def _is_leaf(t) -> bool:
    return not isinstance(t, (dict, list)) and not (
        isinstance(t, tuple) and not (len(t) == 2
                                      and isinstance(t[1], torch.dtype)))


def _walk(tree, path, leaf_fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf_fn) for k, v in tree.items()}
    if not _is_leaf(tree):
        return type(tree)(_walk(v, path + (str(i),), leaf_fn)
                          for i, v in enumerate(tree))
    return leaf_fn(path, _shape_of(tree))


def param_spec_tree(cfg, mesh, params_shape, *, serve_tp_only: bool = False):
    """Spec tree mirroring the port's parameter tree (``init_model``'s, or
    ``transformer.param_specs(cfg)``'s (shape, dtype) leaves).  Rules are
    name-based on the leaf path, the reference's; every layer's leaves
    take the rule of an unstacked leaf.

    ``serve_tp_only`` drops the FSDP ("data") axis from weights: for
    autoregressive decoding FSDP means re-gathering every weight every
    token; serving uses pure tensor parallelism whenever the TP-sharded
    params fit."""
    msz = mesh_axis_size(mesh, "model")
    ep = cfg.moe is not None and cfg.moe.num_experts % msz == 0

    fsdp_fn = _fsdp
    if serve_tp_only:
        def fsdp_fn(mesh_, dim_):
            return None

    def leaf_spec(path: Tuple[str, ...], shape) -> Spec:
        name = path[-1]
        nd = len(shape)
        core = shape

        def sp(*entries):
            entries = list(entries) + [None] * (len(core) - len(entries))
            return Spec(*entries[: len(core)])

        # --- embeddings / unembedding ---
        if name == "table":
            return Spec(_tp(mesh, shape[0]), fsdp_fn(mesh, shape[1]))
        if name == "w" and "lm_head" in path:
            return Spec(fsdp_fn(mesh, shape[0]), _tp(mesh, shape[1]))
        # --- attention (D, H, hd) / (H, hd, D) ---
        if name in ("wq", "wk", "wv"):
            d, h = core[0], core[1]
            tp_h = _tp(mesh, h)
            if tp_h is None:
                # GQA kv heads not divisible by the model axis: shard the
                # contraction dim D on "model" instead
                f = fsdp_fn(mesh, d)
                fax = f if isinstance(f, tuple) else ((f,) if f else ())
                comb = tuple(fax) + ("model",)
                sz = 1
                for ax in comb:
                    sz *= mesh_axis_size(mesh, ax)
                if d % sz == 0:
                    return sp(comb, None, None)
            return sp(fsdp_fn(mesh, d), tp_h, None)
        if name == "wo":
            h, _, d = core
            return sp(_tp(mesh, h), None, fsdp_fn(mesh, d))
        if name in ("bq", "bk", "bv"):
            return sp(_tp(mesh, core[0]), None)
        # --- dense MLP ---
        if name in ("w_gate", "w_up", "w_in") and "experts" not in path:
            return sp(fsdp_fn(mesh, core[0]), _tp(mesh, core[1]))
        if name in ("w_down", "w_out") and "experts" not in path:
            return sp(_tp(mesh, core[0]), fsdp_fn(mesh, core[1]))
        # --- MoE experts (E, D, F) / (E, F, D) ---
        if "experts" in path and name in ("w_gate", "w_up"):
            e, d, f = core
            if ep:
                return sp("model", fsdp_fn(mesh, d), None)
            return sp(None, fsdp_fn(mesh, d), _tp(mesh, f))
        if "experts" in path and name == "w_down":
            e, f, d = core
            if ep:
                return sp("model", None, fsdp_fn(mesh, d))
            return sp(None, _tp(mesh, f), fsdp_fn(mesh, d))
        if name == "router":
            return sp(fsdp_fn(mesh, core[0]), None)
        # --- recurrent blocks ---
        if name in ("w_qkv",):  # (H, dh, dh) blockdiag
            return sp(None, None, _tp(mesh, core[2]))
        if name in ("w_gates_in",):  # (D, n_gates, H, dh)
            return sp(fsdp_fn(mesh, core[0]), None, None, None)
        if name in ("r_gates",):  # (n_gates, H, dh, dh)
            return sp(None, None, None, _tp(mesh, core[3]))
        if name in ("w_x", "w_gate_br", "w_in_gate", "w_rec_gate", "w_ogate"):
            return sp(fsdp_fn(mesh, core[0]),
                      _tp(mesh, core[1]) if len(core) > 1 else None)
        if name in ("w_out_r", "w_out_x", "out_proj"):
            return sp(_tp(mesh, core[0]),
                      fsdp_fn(mesh, core[1]) if len(core) > 1 else None)
        if name == "img_proj":
            return sp(fsdp_fn(mesh, core[0]), None)
        # scales, biases, conv kernels, lambdas, norms: replicate
        return Spec(*([None] * nd))

    return _walk(params_shape, (), leaf_spec)


def decode_state_spec_tree(cfg, mesh, global_batch: int, state_shapes):
    """Spec tree for the port's decode state (``transformer.init_decode_state``:
    one ``{"kv": ...}`` or ``{"rec": ...}`` per layer, ``pos``, and an
    encoder-decoder's stacked ``enc_kv``).

    Policy: batch on ("pod","data") when divisible; KV heads on "model"
    when divisible, else the cache sequence axis on "model"; for B==1
    (long_500k) the cache sequence axis additionally takes the batch axes
    (sequence-parallel cache).  Recurrent states shard their elementwise
    feature axis on "model"."""
    b_ax = batch_spec(mesh, global_batch)
    msz = mesh_axis_size(mesh, "model")
    sizes = mesh_shape(mesh)

    def kv_spec(shape, lead):
        B, W, Hkv, hd = shape[-4:]
        h_ax = "model" if Hkv % msz == 0 else None
        w_axes = []
        if b_ax is None:
            cand = [ax for ax in ("pod", "data") if ax in sizes]
            sz = 1
            for ax in cand:
                sz *= sizes[ax]
            if cand and W % sz == 0:
                w_axes += cand
        if h_ax is None and W % (msz * max(1, math_prod(mesh, w_axes))) == 0:
            w_axes.append("model")
        w = tuple(w_axes) if len(w_axes) > 1 else (w_axes[0] if w_axes
                                                  else None)
        return Spec(*(lead + (b_ax, w, h_ax, None)))

    def leaf(path, shape):
        lead = (None,) if "enc_kv" in path else ()
        name = path[-1]
        core = shape[len(lead):]
        if name in ("k", "v") and ("kv" in path or "enc_kv" in path) \
                and len(core) >= 4:
            return kv_spec(shape, lead)
        if name == "pos":
            if len(core) == 2:  # per-row (B, W) ring position map
                return Spec(*(lead + (b_ax, None)))
            return Spec(*([None] * len(shape)))
        # recurrent states: shard trailing feature axis on model if divisible
        if name in ("h", "c", "n", "m", "C", "conv", "rec"):
            entries = [b_ax] + [None] * (len(core) - 1)
            if len(core) >= 2 and core[-1] % msz == 0:
                entries[-1] = "model"
            return Spec(*(lead + tuple(entries)))
        entries = [b_ax] + [None] * (len(core) - 1)
        return Spec(*(lead + tuple(entries)))

    return _walk(state_shapes, (), leaf)


def math_prod(mesh, axes):
    sizes = mesh_shape(mesh)
    out = 1
    for ax in axes:
        out *= sizes[ax]
    return out


def named(mesh, spec_tree):
    """The tree of DTensor placements of a spec tree (the reference's
    ``NamedSharding`` tree)."""
    if isinstance(spec_tree, Spec):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(named(mesh, v) for v in spec_tree)


def from_local(mesh, local, shape, spec):
    """The DTensor of global ``shape`` under ``spec`` whose shard on this
    rank is ``local`` (no check, no communication)."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def sharded_full(mesh, shape, spec, fill, dtype, device):
    """A DTensor of ``shape`` under ``spec`` filled with ``fill``, of which
    this rank allocates only its shard, on ``device``."""
    loc = torch.full(local_shape(mesh, shape, spec), fill, dtype=dtype,
                     device=device)
    return from_local(mesh, loc, shape, spec)


def micro_slice(x, i: int, m: int):
    """Microbatch ``i`` of ``m`` along the first axis: rows ``[i*n,
    (i+1)*n)`` of a plain tensor; of a DTensor, each rank's i-th block of
    its own rows, with no communication (the microbatches then interleave
    the ranks' rows; each holds B/m rows, as in the reference)."""
    n = x.shape[0] // m
    if not is_dtensor(x):
        return x[i * n: (i + 1) * n]
    loc = x.to_local()
    k = loc.shape[0] // m
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(loc[i * k: (i + 1) * k], x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size((n,) + tuple(x.shape[1:])),
                              stride=torch.empty((n,) + tuple(x.shape[1:]),
                                                 device="meta").stride())


def run_local(fn, args, in_specs, out_placements):
    """``fn(*args)`` on each rank's local shards, the counterpart of a
    ``shard_map`` region for ops that have no DTensor sharding rule (or
    one that would replicate): ``torch.distributed.tensor.experimental.
    local_map`` with each DTensor argument redistributed to its spec in
    ``in_specs`` (entries as :func:`constrain` takes them, filtered on the
    arg's shape; None for a non-tensor).  ``out_placements(mesh)`` gives
    the placements of fn's one output, or a tuple of them for a tuple of
    outputs (Partial where ``fn`` leaves partial sums).
    Outside a mesh, or with no DTensor argument, ``fn(*args)`` itself."""
    mesh = current_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    # a plain tensor is the same on every rank: replicated
    args = tuple(
        DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                           run_check=False)
        if s is not None and isinstance(a, torch.Tensor)
        and not is_dtensor(a) else a
        for a, s in zip(args, in_specs))
    in_pl = tuple(
        None if s is None or not isinstance(a, torch.Tensor)
        else spec_placements(mesh, a.shape, s)
        for a, s in zip(args, in_specs))
    out_pl = out_placements(mesh)
    single = not isinstance(out_pl[0], tuple)
    out = local_map((lambda *a: (fn(*a),)) if single else fn,
                    out_placements=(out_pl,) if single else out_pl,
                    in_placements=in_pl, device_mesh=mesh,
                    redistribute_inputs=True)(*args)
    return out[0] if single else out


def shard_offset(x, dim: int, placements=None) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of DTensor ``x`` along
    ``dim`` (laid out as ``placements``, default its own): the mesh dims
    that shard it split it in mesh order."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    chunk, n = 0, 1
    for i, p in enumerate(placements or x.placements):
        if getattr(p, "dim", None) == dim and p.is_shard():
            size = mesh.size(i)
            chunk, n = chunk * size + coord[i], n * size
    length = x.shape[dim] // n
    return chunk * length, length
