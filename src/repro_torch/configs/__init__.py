"""Architecture registry: ``get_config(arch_id)`` / ``--arch`` support."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced

ARCHS = [
    "whisper_medium",
    "phi3_vision_4b",
    "recurrentgemma_9b",
    "llama4_scout_17b",
    "granite_moe_3b",
    "minitron_8b",
    "phi3_medium_14b",
    "command_r_plus_104b",
    "phi4_mini_3b",
    "xlstm_350m",
]
# configurations the port runs that ``repro`` has no counterpart of, so
# the parity tests over ARCHS leave them out
PORT_ONLY = ["deepseek_v2_lite"]

_ALIASES = {
    "whisper-medium": "whisper_medium",
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "minitron-8b": "minitron_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi4-mini-3.8b": "phi4_mini_3b",
    "xlstm-350m": "xlstm_350m",
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCHS + PORT_ONLY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{ARCHS + PORT_ONLY}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE_CONFIG
