"""Config registry: get_config(arch_id, smoke=False).

The port knows the arch ids of the JAX registry; it brings qwen3-1.7b
(the dense path) and rwkv6-7b (serving) and raises NotImplementedError,
naming the slice that brings it, for the others.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {"qwen3-1.7b": "qwen3_1p7b", "rwkv6-7b": "rwkv6_7b"}

# arch ids of the JAX registry that a later slice of the port brings
_LATER = ("gemma3-27b", "minicpm-2b", "internlm2-1.8b", "arctic-480b",
          "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "whisper-base",
          "qwen2-vl-2b")

ARCH_IDS = tuple(_MODULES) + tuple(_LATER)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _LATER:
        raise NotImplementedError(f"{arch} is not ported yet: it comes "
                                  "with the slice that ports the other "
                                  "model families")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
