"""Config registry: get_config(arch_id, smoke=False).

The port brings every arch id of the JAX registry: the dense decoders
qwen3-1.7b, gemma3-27b (with its local:global attention), internlm2-1.8b
(untied head) and minicpm-2b, the vlm qwen2-vl-2b (the same decoder with
M-RoPE and a patch-embedding prefix), the MoE decoders phi3.5-moe and
arctic-480b (top-k capacity dispatch; arctic with a dense residual FFN),
rwkv6-7b, the hybrid hymba-1.5b (attention and Mamba heads in parallel)
and the encoder-decoder whisper-base; and the shape cells that the JAX
dry run and benchmarks share (`ShapeCell`, `SHAPES`,
`cell_is_applicable`).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1p7b",
    "gemma3-27b": "gemma3_27b",
    "minicpm-2b": "minicpm_2b",
    "internlm2-1.8b": "internlm2_1p8b",
    "rwkv6-7b": "rwkv6_7b",
    "arctic-480b": "arctic_480b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-base": "whisper_base",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_IDS = tuple(_MODULES)          # the JAX registry's ids, in its order


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

# long_500k needs sub-quadratic attention or a bounded state: the pure
# full-attention archs skip it
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "hymba-1.5b", "gemma3-27b")


def cell_is_applicable(arch: str, shape: ShapeCell) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 512k decode skipped"
    return True, ""


def parse_overrides(pairs) -> dict:
    """`--set key=value` strings as the JAX dry run parses them
    (`repro/launch/dryrun.py`): a value becomes an int, else a float, else
    True / False for "True" / "False", else stays a string. Apply them
    with `cfg.replace(**overrides)`, which raises on an unknown field."""
    overrides = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v
    return overrides


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
