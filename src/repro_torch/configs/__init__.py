"""Config registry of the port: ``get_config(name)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (re-exports)
    ModelConfig,
    MoESpec,
    OffloadSpec,
    parse_block,
)

_MODULES = {
    "tiny-moe": "repro_torch.configs.tiny_moe",
    "tiny-draft": "repro_torch.configs.tiny_draft",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mixtral-offload": "repro_torch.configs.mixtral_offload",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
