"""Config registry of the port: ``get_config(name)``, ``list_archs()``."""
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


# the rest of the reference's registry: its config zoo, which the port
# does not run yet (ROADMAP queue 1, item 6)
ZOO = ("command-r-plus-104b", "granite-moe-1b-a400m", "phi-3-vision-4.2b",
       "qwen1.5-4b", "recurrentgemma-9b", "smollm-360m", "stablelm-1.6b",
       "whisper-medium", "xlstm-1.3b")


def list_archs():
    """Every name of the reference's registry, sorted (what the launchers
    accept); :func:`get_config` serves the port's own and refuses the
    zoo's."""
    return sorted(set(_MODULES) | set(ZOO))


def get_config(name: str) -> ModelConfig:
    if name in ZOO:
        raise NotImplementedError(
            f"{name} is in the reference's config zoo, which the port does "
            f"not run yet (ROADMAP queue 1, item 6); the port runs "
            f"{sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
