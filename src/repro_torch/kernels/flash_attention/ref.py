"""Plain PyTorch versions of flash_attention. `flash_attention_ref` is the
CPU path and the card's yardstick for all three CUDA kernels: direct
quadratic attention with a query offset and a key count
(`models/attention.py::direct_attention`, the training path's quadratic
attention, is this function over every key). `flash_attention_split_ref`
repeats the decode kernel's split-and-combine arithmetic; only the tests
call it."""
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


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_split: int, *,
                              causal: bool = True, window: int = 0,
                              q_offset: int = 0,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """`flash_attention_ref` computed as csrc/flash_decode.cu computes it:
    the keys [lo, hi) that some row sees (`kernel.seen_keys`) cut into
    n_split chunks of ceil((hi - lo) / n_split); per chunk and row the fp32
    partials m (max score, -inf if the row sees no key of the chunk),
    l = sum exp(s - m) and acc = sum exp(s - m) v; then, in split order,
    M = max m_s and out = sum exp(m_s - M) acc_s / max(sum exp(m_s - M) l_s,
    1e-30), skipping the chunks with m = -inf."""
    from repro_torch.kernels.flash_attention.kernel import seen_keys
    B, Sq, H, hd = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    lo, hi = seen_keys(Sq, kv_len, causal=causal, window=window,
                       q_offset=q_offset)
    rep = H // k.shape[2]
    kk = k[:, :hi].float().repeat_interleave(rep, dim=2)
    vv = v[:, :hi].float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) \
        * float(1.0 / np.sqrt(hd))
    iq = q_offset + torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(hi, device=q.device)[None, :]
    ok = jk >= lo
    if causal:
        ok = ok & (jk <= iq)
    if window > 0:
        ok = ok & (jk > iq - window)
    s = torch.where(ok[None, None], s, -torch.inf)
    chunk = -(-(hi - lo) // n_split)
    parts = []
    for c0 in range(lo, lo + n_split * chunk, chunk):
        sc = s[..., c0:min(hi, c0 + chunk)]
        m = sc.amax(-1, keepdim=True) if sc.shape[-1] else torch.full(
            s.shape[:-1] + (1,), -torch.inf, device=q.device)
        m_safe = torch.where(m == -torch.inf, 0.0, m)
        p = torch.where(sc == -torch.inf, 0.0, torch.exp(sc - m_safe))
        acc = torch.einsum("bhqk,bkhd->bhqd", p, vv[:, c0:c0 + sc.shape[-1]])
        parts.append((m, p.sum(-1, keepdim=True), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - mx))
        num = num + w * acc
        den = den + w * l
    out = num / den.clamp(min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)
