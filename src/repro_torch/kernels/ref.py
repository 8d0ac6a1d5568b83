"""Plain PyTorch versions of the dequant-matmul kernels' bindings.

They mirror the reference's jnp path (``ref.dequant_matmul_ref``,
``ops._dequant_rows`` and the batched einsum of
``ops.dequant_matmul_batched``/``_slots``):
``_meta_dequantize`` + ``unpack_codes`` + ``(q - zero) * scale`` +
``einsum("bmk,bkn->bmn")`` in float32.  The CPU path of ``kernels/ops``
runs these; on the card ``chip_smoke.py`` holds the kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.quant import hqq


def dequant_rows(qt: hqq.QTensor) -> torch.Tensor:
    """Dequantize a (B, G, pg, N)-packed row stack to (B, K, N) f32."""
    scale, zero = hqq._meta_dequantize(qt)
    B, G, _, N = qt.packed.shape
    q = hqq.unpack_codes(qt.packed, qt.bits, qt.group_size).to(torch.float32)
    w = (q - zero) * scale
    return w.reshape(B, G * qt.group_size, N)


def dequant_matmul(x: torch.Tensor, qt: hqq.QTensor) -> torch.Tensor:
    """x (M, K) @ dequant(qt) for one 2-D weight -> (M, N) f32."""
    w = dequant_rows(stack_one(qt))[0]
    return x.to(torch.float32) @ w


def stack_one(qt: hqq.QTensor) -> hqq.QTensor:
    """A 2-D QTensor as a one-record (1, K, N) stack of views."""
    meta = None if qt.meta is None else {k: v[None] for k, v in qt.meta.items()}
    return hqq.QTensor(qt.packed[None], qt.scale[None], qt.zero[None], meta,
                       qt.bits, qt.group_size, (1,) + tuple(qt.shape))


def dequant_matmul_batched(x: torch.Tensor, qt: hqq.QTensor) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[b]) per row -> (B, M, N) f32."""
    return torch.einsum("bmk,bkn->bmn", x.to(torch.float32), dequant_rows(qt))


def dequant_matmul_grouped(x: torch.Tensor, qt: hqq.QTensor,
                           offsets) -> torch.Tensor:
    """x (R, K), rows sorted into U ragged groups at the host row
    ``offsets`` (U + 1), group u @ dequant(qt[u]) -> (R, N) f32."""
    off = [int(o) for o in offsets]
    U = len(off) - 1
    head = hqq.QTensor(qt.packed[:U], qt.scale[:U], qt.zero[:U],
                       None if qt.meta is None else
                       {k: v[:U] for k, v in qt.meta.items()},
                       qt.bits, qt.group_size, (U,) + tuple(qt.shape[1:]))
    w = dequant_rows(head)
    xf = x.to(torch.float32)
    return torch.cat([xf[off[u]:off[u + 1]] @ w[u] for u in range(U)])


def gather_slots(qt: hqq.QTensor, slots: torch.Tensor) -> hqq.QTensor:
    """The records ``slots`` (B,) of an (S, K, N) stack, copied into a
    (B, K, N) stack."""
    slots = slots.to(device=qt.packed.device, dtype=torch.long)
    meta = None if qt.meta is None else {k: v[slots] for k, v in qt.meta.items()}
    return hqq.QTensor(qt.packed[slots], qt.scale[slots], qt.zero[slots],
                       meta, qt.bits, qt.group_size,
                       (int(slots.shape[0]),) + tuple(qt.shape[1:]))


def dequant_matmul_slots(x: torch.Tensor, qt: hqq.QTensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[slots[b]]) -> (B, M, N) f32: gathers the
    (small, CPU-side) packed leaves and runs the batched version."""
    return dequant_matmul_batched(x, gather_slots(qt, slots))
