"""Model API: build_model(cfg) -> Model with init/loss (the port of
`repro/models/api.py` for the dense family)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]                  # (seed, device="cuda")
    loss: Callable[[dict, dict], torch.Tensor]

    def param_count(self, params: dict) -> int:
        return sum(x.numel() for x in params.values())


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)

    def init(seed: int, device: str | torch.device = "cuda") -> dict:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return transformer.init_params(cfg, gen)

    return Model(cfg=cfg, init=init,
                 loss=lambda p, b: transformer.loss_fn(cfg, p, b))
