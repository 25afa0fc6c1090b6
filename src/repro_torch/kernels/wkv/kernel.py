"""ctypes wrapper of the Hopper wkv kernel (csrc/wkv.cu).

The wrapper checks device, dtype, shapes and contiguity, allocates the
output and the final state with torch, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to
`launches["wkv"]`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build

HEAD_DIMS = (8, 16, 32, 64)

# kernel launches since the last reset_launches()
launches = {"wkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.wkv_fwd.argtypes = [ptr] * 8 + [i64] * 4 + [ptr]
    lib.wkv_fwd.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the card; see ops.wkv for the contract."""
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if B > 65535:
        raise ValueError("batch must be <= 65535")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(t, name, (B, S, H, hd))
    _check(u, "u", (H, hd))
    if state0 is not None:
        _check(state0, "state0", (B, H, hd, hd))
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("inputs must be on one device")
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    rc = _lib().wkv_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), out.data_ptr(),
        state.data_ptr(), B, S, H, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, "wkv launch")
    launches["wkv"] += 1
    return out, state
