"""Convert parameters and AdamW state between numpy trees and the port.

A numpy tree is a flat mapping from the "/"-joined pytree path that the
JAX package's checkpoints use ("embed", "blocks/wq", "mu/blocks/wq",
"count", ...) to an array. The port's parameters use the same paths and
layouts, so every leaf maps one to one. bfloat16 arrays (numpy's
ml_dtypes.bfloat16, the dtype JAX hands out) go through a 16-bit view, so
the round trip is bit-exact.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16; needed only for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def params_from_numpy(tree: Mapping[str, np.ndarray],
                      device: str | torch.device = "cuda") -> dict:
    """{path: array} -> the port's parameter dict (sorted paths, the JAX
    pytree's leaf order)."""
    dev = resolve_device(device)
    return {k: _to_torch(tree[k], dev) for k in sorted(tree)}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    return {k: _to_numpy(v) for k, v in params.items()}


def opt_state_from_numpy(tree: Mapping[str, np.ndarray],
                         device: str | torch.device = "cuda") -> dict:
    """{"mu/<path>", "nu/<path>", "count"} -> the port's AdamW state."""
    dev = resolve_device(device)
    state = {"mu": {}, "nu": {}}
    for key in sorted(tree):
        if key == "count":
            continue
        group, _, path = key.partition("/")
        if group not in state or not path:
            raise KeyError(f"unexpected AdamW state key {key!r}")
        state[group][path] = _to_torch(tree[key], dev)
    state["count"] = _to_torch(np.asarray(tree["count"], np.int32), dev)
    return state


def opt_state_to_numpy(state: Mapping) -> dict:
    out = {f"{g}/{k}": _to_numpy(v) for g in ("mu", "nu")
           for k, v in state[g].items()}
    out["count"] = _to_numpy(state["count"])
    return out
