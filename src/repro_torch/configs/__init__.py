"""Config registry of the port: ``get_config(name)``, ``list_archs()``,
and the reference's ``ASSIGNED_ARCHS``, ``INPUT_SHAPES``, ``SKIPS``,
``SWA_FOR_LONG`` and ``config_for_shape``."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401  (re-exports)
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoESpec,
    OffloadSpec,
    parse_block,
)

_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "mixtral-offload": "repro_torch.configs.mixtral_offload",
    "tiny-moe": "repro_torch.configs.tiny_moe",
    "tiny-draft": "repro_torch.configs.tiny_draft",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ASSIGNED_ARCHS: List[str] = [
    "smollm-360m",
    "recurrentgemma-9b",
    "command-r-plus-104b",
    "granite-moe-1b-a400m",
    "stablelm-1.6b",
    "whisper-medium",
    "phi-3-vision-4.2b",
    "mixtral-8x7b",
    "xlstm-1.3b",
    "qwen1.5-4b",
]

# (arch, shape) combinations that are skipped, with the reason recorded in
# DESIGN.md section 5.  Everything else must run in the dry-run.
SKIPS = {
    ("whisper-medium", "long_500k"):
        "encoder-decoder with architecturally bounded decoder context; "
        "no sub-quadratic decoder variant exists for this family "
        "(DESIGN.md section 5).",
}

# Dense full-attention archs run long_500k via their sliding-window variant
SWA_FOR_LONG = {
    "smollm-360m",
    "command-r-plus-104b",
    "stablelm-1.6b",
    "qwen1.5-4b",
    "phi-3-vision-4.2b",
}


def list_archs() -> List[str]:
    """Every name of the registry, sorted (what the launchers accept): the
    reference's."""
    return sorted(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    """Config actually used for a given input shape (applies the SWA
    variant for ``long_500k``)."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and arch in SWA_FOR_LONG:
        cfg = cfg.with_sliding_window(4096)
    return cfg
