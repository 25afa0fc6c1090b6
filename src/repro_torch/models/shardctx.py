"""Activation-sharding markers (the port of `repro/models/shardctx.py`).

In JAX the dry run sets the batch axes there before it builds a sharded
program, and the model code calls `constrain_batch` on its layer carries
so that XLA keeps the token dimension sharded inside every layer; unset,
the call returns its input. The port runs on one device and holds no
sharded tensors, so it has only `constrain_batch`, which returns its
input, called where JAX's model code calls it: it marks where a sharded
executor would place the batch. Setting the axes comes with the first
caller that sets them, the dry run (ROADMAP.md).
"""
from __future__ import annotations

import torch


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """x's leading (batch) dim on the batch axes: x itself on one device."""
    return x
