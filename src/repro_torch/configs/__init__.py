"""Architecture config registry: ``--arch <id>`` resolution, the JAX
registry's ten ids in its order."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)

_MODULES = {
    "glm4-9b": "glm4_9b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "xlstm-125m": "xlstm_125m",
    "pixtral-12b": "pixtral_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str, **overrides) -> ModelConfig:
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return _module(arch_id).reduced(**overrides)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced", "shape_applicable"]
