"""Architecture registry: ``--arch <id>`` resolution.

The ten assigned architectures, the same as the reference's (the paper's
own MVE geometry config lives in repro_torch.core.machine.MVEConfig).
"""
from __future__ import annotations

from . import (arctic_480b, granite_34b, llama4_scout_17b,
               llama_3_2_vision_11b, mamba2_2_7b, nemotron_4_15b,
               qwen2_0_5b, qwen2_72b, whisper_base, zamba2_2_7b)
from .base import SHAPES, ModelConfig, ShapeCell, cell_supported  # noqa

_MODULES = {
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "mamba2-2.7b": mamba2_2_7b,
    "qwen2-72b": qwen2_72b,
    "qwen2-0.5b": qwen2_0_5b,
    "nemotron-4-15b": nemotron_4_15b,
    "granite-34b": granite_34b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "arctic-480b": arctic_480b,
    "zamba2-2.7b": zamba2_2_7b,
    "whisper-base": whisper_base,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.reduced() if reduced else mod.CONFIG
