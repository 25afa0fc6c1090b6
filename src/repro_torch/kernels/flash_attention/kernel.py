"""ctypes wrapper of the Hopper flash-attention forward kernel
(csrc/flash_attention.cu).

The wrapper checks device, dtype, shapes and the last dim's contiguity,
passes the other strides through (so a layer's slice of a KV cache is read
in place), allocates the output with torch, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to
`launches["flash_attention"]`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)

# kernel launches since the last reset_launches()
launches = {"flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 4 + [i64] * 5 + [i64] * 12 + [i64] * 4
        + [ctypes.c_double, i64, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, q_offset: int,
                         kv_len: int) -> torch.Tensor:
    """The kernel on the card; see ops.flash_attention for the contract
    (the row precondition is checked there)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D with a contiguous last "
                             f"dim, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v must be on one device")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if B > 65535 or KV > 65535:
        raise ValueError("batch and kv heads must each be <= 65535")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    scale = 1.0 / float(np.sqrt(hd))
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], q_offset, kv_len, window,
        int(causal), scale, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention launch")
    launches["flash_attention"] += 1
    return out
