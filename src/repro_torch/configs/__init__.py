# Copy of src/repro/configs/__init__.py (commit 9368fdf); imports may differ.
"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from ..models.config import ModelConfig

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-0.6b": "qwen3_0_6b",
    "zamba2-7b": "zamba2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-medium": "whisper_medium",
    "xlstm-125m": "xlstm_125m",
}

ARCHS: Dict[str, ModelConfig] = {}
SMOKE: Dict[str, ModelConfig] = {}
for name, mod in _MODULES.items():
    m = import_module(f"repro_torch.configs.{mod}")
    ARCHS[name] = m.CONFIG
    SMOKE[name] = m.SMOKE


def get(name: str, smoke: bool = False) -> ModelConfig:
    return (SMOKE if smoke else ARCHS)[name]
