"""ctypes bindings of the Hopper kernels that replace the reference's
``dequant_matmul_batched_pallas``, ``dequant_matmul_slots_pallas`` and (as
its B = 1 case) ``dequant_matmul_pallas``
(``src/repro/kernels/dequant_matmul.py``):

* :func:`launch`: a (B, M, K) batch, by slot or row b -> record b: decode
  and the 2-D binding.  Two routes: bfloat16 x with at most 8 rows per
  record, in the tensor-core kernel's scope (:func:`gemv_scope`), runs
  ``csrc/dequant_gemv.cu`` (:func:`launch_gemv`); float32 x, more rows,
  or other shapes run the FMA kernel of ``csrc/dequant_matmul.cu``.
  ``launch.routes`` counts the launches of each route ("gemv", "fma").
* :func:`launch_grouped`: rows sorted into ragged groups, group u against
  record u: ``csrc/dequant_grouped.cu`` (tensor cores) for bfloat16 x,
  the ragged entry of ``csrc/dequant_matmul.cu`` for float32 x.

Each checks every tensor it is given (device, dtype, shape, per-record
contiguity, alignment), allocates the output, launches on PyTorch's
current stream and raises when the launch is refused.  Neither
synchronises.  The slot map must index the tier: the kernel cannot check
it without a device round trip.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.quant import hqq

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _fn(source: str, name: str, argtypes):
    """Function ``name`` of the library built from ``csrc/<source>.cu``,
    its argument types set on first use."""
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _lib():
    return _fn("dequant_matmul", "dequant_matmul",
               [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P])


def _slot_stride(t: torch.Tensor, what: str, dtype, device) -> int:
    """Stride (elements) between the slots of a (S, ...) leaf whose every
    slot is one contiguous block; raises otherwise."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, x on {device}")
    expect = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size > 1 and stride != expect:
            raise ValueError(f"{what}: each slot must be contiguous "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")
        expect *= size
    stride0 = t.stride(0) if t.shape[0] > 1 else expect
    if (t.data_ptr() % 4) or (stride0 * t.element_size()) % 4:
        raise ValueError(f"{what}: slots must start on 4-byte boundaries")
    return stride0


def _leaf_strides(qt: hqq.QTensor, K: int, dev):
    """Check an (S, K, N) meta-quantized stack against K and the device;
    returns (N, group size, groups per meta group, leaf strides)."""
    if qt.meta is None:
        raise ValueError("the kernel reads meta-quantized scale/zero; a "
                         "QTensor without meta runs on the plain path only")
    if qt.bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported bits={qt.bits}")
    S, Kw, N = qt.shape
    G, gs = K // qt.group_size, qt.group_size
    if Kw != K or G * gs != K:
        raise ValueError(f"x has K={K}, weights {tuple(qt.shape)} in groups "
                         f"of {gs}")
    if N % 4:
        raise ValueError(f"N={N} must be a multiple of 4")
    pg = gs * qt.bits // 8
    sg = qt.scale.shape[2]
    if (tuple(qt.packed.shape) != (S, G, pg, N)
            or tuple(qt.scale.shape) != (S, G // sg, sg, 1, N)
            or tuple(qt.zero.shape) != tuple(qt.scale.shape)
            or any(tuple(qt.meta[k].shape) != (S, G // sg, 1, 1, N)
                   for k in hqq.META_KEYS)):
        raise ValueError("QTensor leaves do not match an (S, K, N) "
                         "meta-quantized stack")
    ps = _slot_stride(qt.packed, "packed", torch.uint8, dev)
    ss = _slot_stride(qt.scale, "scale", torch.uint8, dev)
    zs = _slot_stride(qt.zero, "zero", torch.uint8, dev)
    ms = {_slot_stride(qt.meta[k], k, torch.float16, dev) for k in hqq.META_KEYS}
    if len(ms) != 1:
        raise ValueError("the four meta leaves must share one slot stride")
    return N, gs, sg, (ps, ss, zs, ms.pop())


def _leaf_args(qt: hqq.QTensor, strides):
    ps, ss, zs, ms = strides
    return (qt.packed.data_ptr(), ps, qt.scale.data_ptr(), ss,
            qt.zero.data_ptr(), zs,
            qt.meta["s_scale"].data_ptr(), qt.meta["s_min"].data_ptr(),
            qt.meta["z_scale"].data_ptr(), qt.meta["z_min"].data_ptr(), ms)


def _check_x(x: torch.Tensor, dims: int, what: str) -> None:
    if not x.is_cuda:
        raise ValueError("the CUDA kernel takes tensors on the card")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_X_DTYPES)}")
    if x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {what} tensor, got "
                         f"{tuple(x.shape)}")


def _slot_args(x: torch.Tensor, qt: hqq.QTensor, slots):
    """Checks shared by both routes: (B, M, K, N, group size, meta group,
    leaf strides, slot pointer or None)."""
    _check_x(x, 3, "(B, M, K)")
    B, M, K = x.shape
    dev = x.device
    N, gs, sg, strides = _leaf_strides(qt, K, dev)
    if slots is None:
        if B > qt.shape[0]:
            raise ValueError(f"{B} rows over a stack of {qt.shape[0]} slots")
        slot_ptr = None
    else:
        if (slots.dtype != torch.int32 or slots.device != dev
                or tuple(slots.shape) != (B,) or not slots.is_contiguous()):
            raise ValueError("slots must be a contiguous (B,) int32 tensor "
                             "on the card")
        slot_ptr = slots.data_ptr()
    return B, M, K, N, gs, sg, strides, slot_ptr


def _fma(x, qt, args) -> torch.Tensor:
    B, M, K, N, gs, sg, strides, slot_ptr = args
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    rc = _lib()(x.data_ptr(), _X_DTYPES[x.dtype], out.data_ptr(), slot_ptr,
                B, M, K, N, qt.bits, gs, sg, *_leaf_args(qt, strides),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {rc}")
    return out


def _launch_fma(x: torch.Tensor, qt: hqq.QTensor,
                slots: Optional[torch.Tensor]) -> torch.Tensor:
    """The FMA kernel of ``csrc/dequant_matmul.cu`` alone (float32 or
    bfloat16 x, any M, any group size): the route outside the GEMV's
    scope, and the previous decode kernel, timed beside it."""
    return _fma(x, qt, _slot_args(x, qt, slots))


GEMV_KS = 64          # k per stage of the tensor-core GEMV
GEMV_WARPS = 4        # warps of a block, each a run of stages
GEMV_BN = 128         # columns per block
GEMV_MAX_ROWS = 8     # x rows per record (the n8 of mma.sync)
GEMV_MAX_CLUSTER = 2  # larger clusters measured slower at B >= 2 (PERF.md)


def gemv_cluster(K: int, N: int, n_sm: int = 132) -> int:
    """Blocks of a thread block cluster that split K in the tensor-core
    GEMV: 2 where the column tiles alone are fewer than the SMs and every
    warp keeps at least two 64-k stages, else 1.  A function of (K, N)
    only, so an output row never depends on B or the slot map."""
    tiles, stages, cl = -(-N // GEMV_BN), K // GEMV_KS, 1
    while (cl < GEMV_MAX_CLUSTER and tiles * cl < n_sm
           and stages >= 2 * (2 * cl) * GEMV_WARPS):
        cl *= 2
    return cl


def gemv_parts(K: int, cl: int):
    """The 64-k stages [lo, hi) of each (cluster rank, warp), as the kernel
    cuts them: part p = rank * 4 + warp of cl * 4 takes stages
    [p * S // P, (p + 1) * S // P)."""
    S, P = K // GEMV_KS, cl * GEMV_WARPS
    return [(p // GEMV_WARPS, p % GEMV_WARPS, p * S // P, (p + 1) * S // P)
            for p in range(P)]


def gemv_scope(x: torch.Tensor, qt: hqq.QTensor, strides) -> Optional[str]:
    """None when the tensor-core GEMV reads ``x`` (B, M, K) against the
    checked stack ``qt`` (its leaf strides ``strides``, from
    :func:`_leaf_strides`), else why not (the FMA kernel's case)."""
    B, M, K = x.shape
    gs, sg = qt.group_size, qt.scale.shape[2]
    if x.dtype != torch.bfloat16:
        return f"x is {x.dtype}, the tensor-core GEMV reads bfloat16"
    if not 1 <= M <= GEMV_MAX_ROWS:
        return f"{M} rows per record, the tensor-core GEMV takes 1-8"
    if K % GEMV_KS or qt.shape[-1] % 16:
        return f"K={K} not a multiple of 64 or N={qt.shape[-1]} of 16"
    if gs != (16 if qt.bits == 2 else 64) or sg % (GEMV_KS // gs):
        return (f"group size {gs} / meta group {sg} at {qt.bits} bits: the "
                f"tensor-core GEMV takes hqq.quantize's (16 at 2 bits, 64 "
                f"otherwise, meta groups covering whole 64-k stages)")
    ptrs = [x.data_ptr(), qt.packed.data_ptr(), qt.scale.data_ptr(),
            qt.zero.data_ptr()] + [qt.meta[k].data_ptr() for k in hqq.META_KEYS]
    ps, ss, zs, ms = strides
    if any(p % 16 for p in ptrs) or any(s % 16 for s in (ps, ss, zs, 2 * ms)):
        return "the tensor-core GEMV reads 16-byte aligned leaves and records"
    return None


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemv(x, qt, args) -> torch.Tensor:
    B, M, K, N, gs, sg, strides, slot_ptr = args
    cl = gemv_cluster(K, N, _n_sm(x.device.index or 0))
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    fn = _fn("dequant_gemv", "dequant_gemv",
             [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P])
    rc = fn(x.data_ptr(), out.data_ptr(), slot_ptr, B, M, K, N, qt.bits, gs,
            sg, cl, *_leaf_args(qt, strides),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_gemv launch failed: CUDA error {rc}")
    return out


def launch_gemv(x: torch.Tensor, qt: hqq.QTensor,
                slots: Optional[torch.Tensor]) -> torch.Tensor:
    """The tensor-core GEMV (``csrc/dequant_gemv.cu``) alone: raises
    ValueError outside its scope (:func:`gemv_scope`)."""
    args = _slot_args(x, qt, slots)
    why = gemv_scope(x, qt, args[6])
    if why is not None:
        raise ValueError(why)
    return _gemv(x, qt, args)


def launch(x: torch.Tensor, qt: hqq.QTensor,
           slots: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[slots[b]]) -> (B, M, N) float32, where
    ``qt`` stacks (S, K, N) meta-quantized weights; ``slots=None`` reads
    slot b for row b.  The tensor-core GEMV where :func:`gemv_scope`
    admits the inputs, else the FMA kernel."""
    args = _slot_args(x, qt, slots)
    route = "gemv" if gemv_scope(x, qt, args[6]) is None else "fma"
    out = (_gemv if route == "gemv" else _fma)(x, qt, args)
    launch.routes[route] += 1
    return out


launch.routes = {"gemv": 0, "fma": 0}  # launches by route, never reset here


MAX_GROUPS = 256  # the kernels take the offsets by value


# x, out, offsets, U, K, N, bits, group size, meta group, the leaves
_GROUPED_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L]


def launch_grouped(x: torch.Tensor, qt: hqq.QTensor,
                   offsets: Sequence[int]) -> torch.Tensor:
    """x (R, K), its rows sorted into U ragged groups by the host row
    offsets ``offsets`` (U + 1 ints, 0 first, R last), group u @
    dequant(qt[u]) -> (R, N) float32.  bfloat16 x runs the tensor-core
    kernel (``csrc/dequant_grouped.cu``: N a multiple of 64, K of 256,
    group sizes 16 at 2 bits and 64 otherwise, ``hqq.quantize``'s meta
    groups, 16-byte aligned records); float32 x the ragged entry of
    ``csrc/dequant_matmul.cu``.  ``last_bm`` keeps the row tile of the
    last tensor-core launch; ``routes`` counts the launches by route
    ("grouped", "fma")."""
    _check_x(x, 2, "(R, K)")
    R, K = x.shape
    dev = x.device
    N, gs, sg, strides = _leaf_strides(qt, K, dev)
    off = np.asarray(offsets, dtype=np.int64)
    U = len(off) - 1
    if (off.ndim != 1 or U < 1 or U > MAX_GROUPS or off[0] != 0
            or off[-1] != R or (np.diff(off) < 0).any() or U > qt.shape[0]):
        raise ValueError(f"offsets must rise from 0 to {R} over at most "
                         f"{min(MAX_GROUPS, qt.shape[0])} groups: {off}")
    off32 = (ctypes.c_int * (U + 1))(*off.tolist())
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (U, K, N, qt.bits, gs, sg, *_leaf_args(qt, strides))
    if x.dtype == torch.bfloat16:
        if (K % 256 or N % 64 or gs != (16 if qt.bits == 2 else 64)
                or sg % (256 // gs)):
            raise ValueError(f"the grouped kernel takes K a multiple of 256, "
                             f"N of 64, group size {16 if qt.bits == 2 else 64}"
                             f" at {qt.bits} bits and meta groups of a multiple"
                             f" of 256 / group size groups: K={K}, N={N}, "
                             f"group {gs}, meta group {sg}")
        if any(p % 16 for p in (x.data_ptr(), qt.packed.data_ptr(),
                                qt.scale.data_ptr(), qt.zero.data_ptr())) \
                or any(st % 16 for st in strides[:3]):
            raise ValueError("the grouped kernel reads 16-byte aligned rows "
                             "and records")
        bm = ctypes.c_int(0)
        rc = _fn("dequant_grouped", "dequant_grouped", _GROUPED_ARGS + [_P, _P])(
            x.data_ptr(), out.data_ptr(), off32, *args, ctypes.byref(bm), stream)
        launch_grouped.last_bm = bm.value
        route = "grouped"
    else:
        rc = _fn("dequant_matmul", "dequant_matmul_ragged", _GROUPED_ARGS + [_P])(
            x.data_ptr(), out.data_ptr(), off32, *args, stream)
        route = "fma"
    if rc != 0:
        raise RuntimeError(f"grouped dequant_matmul launch failed: CUDA "
                           f"error {rc}")
    launch_grouped.routes[route] += 1
    return out


launch_grouped.last_bm = 0
launch_grouped.routes = {"grouped": 0, "fma": 0}  # never reset here
