"""Model API: build_model(cfg) -> Model with init/loss/prefill/decode_step/
init_cache (the port of `repro/models/api.py` for the dense and rwkv6
families).

  prefill:     (params, {tokens (B,S)}) -> (logits (B,V) fp32, cache)
  decode_step: (params, cache, tokens (B,1), pos int) -> (logits, cache)
  init_cache:  (batch, max_len, device="cuda") -> cache
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, transformer


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


def _no_loss(cfg: ModelConfig):
    def loss(params, batch):
        raise NotImplementedError(
            f"{cfg.name}: rwkv6 training is not ported yet (it needs a "
            "backward of the wkv kernel)")
    return loss


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "rwkv6":
        mod, loss = rwkv6, _no_loss(cfg)
    else:
        transformer.check_supported(cfg)
        mod = transformer
        loss = lambda p, b: transformer.loss_fn(cfg, p, b)   # noqa: E731

    def init(seed: int, device: str | torch.device = "cuda") -> dict:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return mod.init_params(cfg, gen)

    return Model(
        cfg=cfg, init=init, loss=loss,
        prefill=lambda p, b: mod.prefill(cfg, p, b["tokens"]),
        decode_step=lambda p, c, t, pos: mod.decode_step(cfg, p, c, t, pos),
        init_cache=lambda b, s, device="cuda": mod.init_cache(cfg, b, s,
                                                              device))
