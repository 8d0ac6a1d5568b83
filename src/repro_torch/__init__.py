"""PyTorch/CUDA port of the MoE-offloading system (arXiv:2312.17238).

The JAX package ``repro`` is the reference; this package mirrors its
sub-package layout and names.  It imports ``torch`` and numpy only.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default; the CPU
    only when asked for by name.  No GPU and no device given is an error,
    never a quiet fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
