"""Plain PyTorch version of flash_attention (the CPU path and the card's
yardstick for the CUDA kernel): direct quadratic attention with a query
offset and a key count. `models/attention.py::direct_attention`, the
training path's quadratic attention, is this function over every key."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (B,Sq,H,hd) in q's dtype.

    Query row i sits at position iq = q_offset + i; key jk is seen when
    jk < kv_len (default Skv), jk <= iq if causal, and jk > iq - window if
    window > 0. Keys at or past kv_len are dropped before the product (a
    masked key's weight is exactly 0 in fp32, so this equals masking them).
    Softmax in fp32.
    """
    B, Sq, H, hd = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    k, v = k[:, :kv_len], v[:, :kv_len]
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / float(np.sqrt(np.float32(hd)))
    iq = q_offset + torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(kv_len, device=q.device)[None, :]
    ok = torch.ones((Sq, kv_len), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (jk <= iq)
    if window > 0:
        ok = ok & (jk > iq - window)
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
