"""The port's kernel bindings, dispatched on the device of the tensors
they are given: the three bindings of the dequant-matmul kernel, the
flash-attention kernel's (``kernels/flash_attention.py``) and the ragged
paged-attention kernel's (``kernels/ragged_attention.py``).

* A CPU tensor runs the plain PyTorch version (``kernels/ref.py``,
  ``flash_attention_reference``, ``ragged_attention_reference``).
* A CUDA tensor launches the Hopper kernel (``csrc/*.cu``) or raises;
  there is no fall back to the plain version.

Each binding counts its kernel launches in ``.launches``, a plain integer
(:func:`reset_launches` sets them to 0), so that a run can show that its
main path went through the kernel.  Plain-version calls do not count.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ragged_attention import ragged_attention
from repro_torch.quant import hqq


def dequant_matmul(x: torch.Tensor, qt: hqq.QTensor) -> torch.Tensor:
    """x (M, K) @ dequant(qt) for one 2-D packed weight (K, N); float32
    out.  The kernel's B = 1 case: the leaves are read in place as a
    one-record stack, so a pool slot's view is never copied.  Every M and
    every bit width launches the kernel on the card."""
    assert len(qt.shape) == 2, "2-D weights (reshape heads first)"
    if x.device.type == "cpu":
        return ref.dequant_matmul(x, qt)
    from repro_torch.kernels import dequant_matmul as DM
    out = DM.launch(x[None], ref.stack_one(qt), None)[0]
    dequant_matmul.launches += 1
    return out


def dequant_matmul_batched(x: torch.Tensor, qt: hqq.QTensor,
                           offsets: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
    """Group-wise x @ dequant(qt[u]) over a stacked packed tier (S, K, N);
    float32 out.  With ``offsets`` (U + 1 host row offsets), x (R, K)
    holds U ragged row groups sorted by group and group u reads record u
    -> (R, N).  Without, x (B, M, K) is B groups of M rows (``offsets =
    arange(B + 1) * M``) -> (B, M, N).  On the card one launch of the
    grouped kernel (``kernels/dequant_matmul.launch_grouped``)."""
    assert len(qt.shape) == 3, "expect (B,)-stacked 2-D weights"
    if x.device.type == "cpu":
        if offsets is None:
            return ref.dequant_matmul_batched(x, qt)
        return ref.dequant_matmul_grouped(x, qt, offsets)
    from repro_torch.kernels import dequant_matmul as DM
    if offsets is None:
        DM._check_x(x, 3, "(B, M, K)")
        B, M, K = x.shape
        out = DM.launch_grouped(x.reshape(B * M, K), qt,
                                np.arange(B + 1) * M).reshape(B, M, -1)
    else:
        out = DM.launch_grouped(x, qt, offsets)
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


dequant_matmul.launches = 0
dequant_matmul_batched.launches = 0
dequant_matmul_slots.launches = 0
BINDINGS = (dequant_matmul, dequant_matmul_batched, dequant_matmul_slots,
            flash_attention, ragged_attention)


def reset_launches() -> None:
    for fn in BINDINGS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in BINDINGS}


def routes() -> dict:
    """Launches by route of the dequant, ragged and flash kernels (the
    tensor-core kernels or the ones they replaced), counted since the
    process started (never reset)."""
    from repro_torch.kernels import dequant_matmul as DM, flash_attention as FA
    from repro_torch.kernels import ragged_attention as RA
    return {**{f"dequant_{k}": v for k, v in DM.launch.routes.items()},
            **{f"grouped_{k}": v for k, v in DM.launch_grouped.routes.items()},
            **{f"ragged_{k}": v for k, v in RA.launch.routes.items()},
            **{f"flash_{k}": v for k, v in FA.launch.routes.items()}}
