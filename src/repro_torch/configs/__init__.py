"""Config registry: get_config(arch_id, smoke=False).

The port knows the arch ids of the JAX registry; it brings the dense
decoders qwen3-1.7b, gemma3-27b (with its local:global attention),
internlm2-1.8b (untied head) and minicpm-2b, the vlm qwen2-vl-2b (the same
decoder with M-RoPE and a patch-embedding prefix), rwkv6-7b (serving), the
hybrid hymba-1.5b (attention and Mamba heads in parallel) and the
encoder-decoder whisper-base, and raises NotImplementedError, naming the
slice that brings them, for the two MoE configs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {"qwen3-1.7b": "qwen3_1p7b", "gemma3-27b": "gemma3_27b",
            "rwkv6-7b": "rwkv6_7b", "internlm2-1.8b": "internlm2_1p8b",
            "minicpm-2b": "minicpm_2b", "qwen2-vl-2b": "qwen2_vl_2b",
            "hymba-1.5b": "hymba_1p5b", "whisper-base": "whisper_base"}

# arch ids of the JAX registry that a later slice of the port brings
_LATER = ("arctic-480b", "phi3.5-moe-42b-a6.6b")

ARCH_IDS = tuple(_MODULES) + tuple(_LATER)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _LATER:
        raise NotImplementedError(f"{arch} is not ported yet: it comes "
                                  "with the slice that ports the MoE "
                                  "family (models/moe.py's top-k capacity "
                                  "dispatch)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
