"""The two bindings of the dequant-matmul kernel, dispatched on the device
of the tensors they are given.

* A CPU tensor runs the plain PyTorch version (``kernels/ref.py``).
* A CUDA tensor launches the Hopper kernel (``csrc/dequant_matmul.cu``)
  or raises; there is no fall back to the plain version.

Each binding counts its kernel launches in ``.launches``, a plain integer
(:func:`reset_launches` sets both to 0), so that a run can show that its
main path went through the kernel.  Plain-version calls do not count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.quant import hqq


def dequant_matmul_batched(x: torch.Tensor, qt: hqq.QTensor) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[b]) per row, ``qt`` stacked (B, K, N)
    packed; float32 out.  The kernel binding with ``slots = arange(B)``."""
    assert len(qt.shape) == 3, "expect (B,)-stacked 2-D weights"
    if x.device.type == "cpu":
        return ref.dequant_matmul_batched(x, qt)
    from repro_torch.kernels import dequant_matmul as DM
    out = DM.launch(x, qt, None)
    dequant_matmul_batched.launches += 1
    return out


def dequant_matmul_slots(x: torch.Tensor, qt: hqq.QTensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """x (B, M, K) @ dequant(qt[slots[b]]): a batch of matmuls served by
    slot index into a stacked packed tier (S, K, N), read in place."""
    assert len(qt.shape) == 3, "expect (S,)-stacked 2-D weights"
    if x.device.type == "cpu":
        return ref.dequant_matmul_slots(x, qt, slots)
    from repro_torch.kernels import dequant_matmul as DM
    out = DM.launch(x, qt, slots)
    dequant_matmul_slots.launches += 1
    return out


dequant_matmul_batched.launches = 0
dequant_matmul_slots.launches = 0
BINDINGS = (dequant_matmul_batched, dequant_matmul_slots)


def reset_launches() -> None:
    for fn in BINDINGS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in BINDINGS}
