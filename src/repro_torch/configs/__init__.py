"""Architecture registry of the port (the reference's ``repro.configs``,
for the architectures whose paths are ported).

Each module exports ``CONFIG`` (the published configuration) and
``smoke_config()`` (a small same-family configuration for the CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# arch-id -> module name
_REGISTRY: Dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen3-8b": "qwen3_8b",
    "yi-6b": "yi_6b",
    "granite-34b": "granite_34b",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-34b": "llava_next_34b",
}

#: the ten assigned architectures, in the reference's order
ASSIGNED_ARCHS: List[str] = [
    "rwkv6-3b", "phi3-mini-3.8b", "qwen3-8b", "yi-6b", "granite-34b",
    "llava-next-34b", "seamless-m4t-large-v2", "grok-1-314b",
    "deepseek-v2-lite-16b", "recurrentgemma-2b"]


def _module(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    cfg = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    cfg = _module(arch).smoke_config()
    cfg.validate()
    return cfg
