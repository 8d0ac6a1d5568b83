"""ctypes bindings of the Hopper kernels that replace the reference's
``dequant_matmul_batched_pallas``, ``dequant_matmul_slots_pallas`` and (as
its B = 1 case) ``dequant_matmul_pallas``
(``src/repro/kernels/dequant_matmul.py``):

* :func:`launch`: ``csrc/dequant_matmul.cu`` over a (B, M, K) batch, by
  slot or row b -> record b: decode and the 2-D binding.
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


def launch(x: torch.Tensor, qt: hqq.QTensor,
           slots: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[slots[b]]) -> (B, M, N) float32, where
    ``qt`` stacks (S, K, N) meta-quantized weights; ``slots=None`` reads
    slot b for row b."""
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
    out = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    rc = _lib()(x.data_ptr(), _X_DTYPES[x.dtype], out.data_ptr(), slot_ptr,
                B, M, K, N, qt.bits, gs, sg, *_leaf_args(qt, strides),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {rc}")
    return out


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
    last tensor-core launch."""
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
    else:
        rc = _fn("dequant_matmul", "dequant_matmul_ragged", _GROUPED_ARGS + [_P])(
            x.data_ptr(), out.data_ptr(), off32, *args, stream)
    if rc != 0:
        raise RuntimeError(f"grouped dequant_matmul launch failed: CUDA "
                           f"error {rc}")
    return out


launch_grouped.last_bm = 0
