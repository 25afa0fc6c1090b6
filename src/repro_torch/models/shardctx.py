"""Activation-sharding markers (the port of `repro/models/shardctx.py`).

In JAX the dry run sets the batch axes here before it builds a sharded
program, and the model code calls `constrain_batch` on its layer carries
so that XLA keeps the token dimension sharded inside every layer; unset,
the calls return their input. The port runs on one device and holds no
sharded tensors: `set_batch_axes` / `get_batch_axes` keep the axes as
JAX's do (the dry run sets them around each cell), and `constrain_batch`
and `constrain` return their input, set or not. They mark where a sharded
executor would place the batch (ROADMAP.md: the GSPMD step on more than
one rank).
"""
from __future__ import annotations

from typing import Optional

import torch

_BATCH_AXES: Optional[tuple] = None


def set_batch_axes(axes: Optional[tuple]) -> None:
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes) if axes else None


def get_batch_axes() -> Optional[tuple]:
    return _BATCH_AXES


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """x's leading (batch) dim on the batch axes: x itself on one device."""
    return x


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """x placed by partition spec `spec`: x itself on one device."""
    return x
