"""Architecture registry: --arch <id> -> ModelConfig (full + smoke)."""
from __future__ import annotations

import importlib

ARCHS = {
    "minicpm3-4b": "minicpm3_4b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "deepseek-7b": "deepseek_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "paligemma-3b": "paligemma_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke()


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs"]
