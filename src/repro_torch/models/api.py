"""Model API: build_model(cfg) -> Model with init/loss/prefill/decode_step/
init_cache (the port of `repro/models/api.py` for every family: dense,
vlm and moe share the transformer, as in the JAX package; rwkv6, hymba
and whisper have their own modules).

  loss:        (params, {tokens, labels, [frames], [positions],
                         [prefix_embeds]})
  prefill:     (params, {tokens (B,S), [frames (B,F,d)]})
               -> (logits (B,V) fp32, cache)
  decode_step: (params, cache, tokens (B,1), pos int) -> (logits, cache)
  init_cache:  (batch, max_len, device="cuda") -> cache
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hymba, rwkv6, transformer, whisper


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]                  # (seed, device="cuda")
    loss: Callable[[dict, dict], torch.Tensor]
    prefill: Callable[[dict, dict], tuple]
    decode_step: Callable[[dict, dict, torch.Tensor, int], tuple]
    init_cache: Callable[..., dict]            # (batch, max_len, device)

    def param_count(self, params: dict) -> int:
        return sum(x.numel() for x in params.values())


def build_model(cfg: ModelConfig) -> Model:
    mod = {"rwkv6": rwkv6, "hymba": hymba,
           "whisper": whisper}.get(cfg.family)
    if mod is None:
        transformer.check_supported(cfg)
        mod = transformer
    loss = lambda p, b: mod.loss_fn(cfg, p, b)   # noqa: E731
    if cfg.family == "whisper":
        prefill = lambda p, b: whisper.prefill(   # noqa: E731
            cfg, p, b["tokens"], b["frames"])
    else:
        prefill = lambda p, b: mod.prefill(cfg, p, b["tokens"])  # noqa: E731

    def init(seed: int, device: str | torch.device = "cuda") -> dict:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return mod.init_params(cfg, gen)

    return Model(
        cfg=cfg, init=init, loss=loss, prefill=prefill,
        decode_step=lambda p, c, t, pos: mod.decode_step(cfg, p, c, t, pos),
        init_cache=lambda b, s, device="cuda": mod.init_cache(cfg, b, s,
                                                              device))
