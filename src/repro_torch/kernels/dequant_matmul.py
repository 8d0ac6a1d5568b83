"""ctypes binding of ``csrc/dequant_matmul.cu``, the Hopper kernel that
replaces the reference's ``dequant_matmul_batched_pallas``,
``dequant_matmul_slots_pallas`` and (as its B = 1 case)
``dequant_matmul_pallas`` (``src/repro/kernels/dequant_matmul.py``).

:func:`launch` checks every tensor it is given (device, dtype, shape,
per-slot contiguity, alignment), allocates the output, launches on
PyTorch's current stream and raises when the launch is refused.  It never
synchronises.  The slot map must index the tier: the kernel cannot check
it without a device round trip.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant import hqq

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.load("dequant_matmul")
    fn = lib.dequant_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P]
        fn.restype = _I
    return fn


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


def launch(x: torch.Tensor, qt: hqq.QTensor,
           slots: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[slots[b]]) -> (B, M, N) float32, where
    ``qt`` stacks (S, K, N) meta-quantized weights; ``slots=None`` reads
    slot b for row b."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernel takes tensors on the card")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_X_DTYPES)}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, M, K) tensor, got "
                         f"{tuple(x.shape)}")
    if qt.meta is None:
        raise ValueError("the kernel reads meta-quantized scale/zero; a "
                         "QTensor without meta runs on the plain path only")
    if qt.bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported bits={qt.bits}")
    B, M, K = x.shape
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
    dev = x.device
    ps = _slot_stride(qt.packed, "packed", torch.uint8, dev)
    ss = _slot_stride(qt.scale, "scale", torch.uint8, dev)
    zs = _slot_stride(qt.zero, "zero", torch.uint8, dev)
    ms = {_slot_stride(qt.meta[k], k, torch.float16, dev) for k in hqq.META_KEYS}
    if len(ms) != 1:
        raise ValueError("the four meta leaves must share one slot stride")
    if slots is None:
        if B > S:
            raise ValueError(f"{B} rows over a stack of {S} slots")
        slot_ptr = None
    else:
        if (slots.dtype != torch.int32 or slots.device != dev
                or tuple(slots.shape) != (B,) or not slots.is_contiguous()):
            raise ValueError("slots must be a contiguous (B,) int32 tensor "
                             "on the card")
        slot_ptr = slots.data_ptr()
    out = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    rc = _lib()(x.data_ptr(), _X_DTYPES[x.dtype], out.data_ptr(), slot_ptr,
                B, M, K, N, qt.bits, gs, sg,
                qt.packed.data_ptr(), ps, qt.scale.data_ptr(), ss,
                qt.zero.data_ptr(), zs,
                qt.meta["s_scale"].data_ptr(), qt.meta["s_min"].data_ptr(),
                qt.meta["z_scale"].data_ptr(), qt.meta["z_min"].data_ptr(),
                ms.pop(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {rc}")
    return out

