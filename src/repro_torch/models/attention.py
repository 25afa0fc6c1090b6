"""GQA attention (the port of `repro/models/attention.py`).

Training: a direct quadratic path and a chunked online-softmax path, plain
PyTorch, as the JAX package computes them in jnp outside any Pallas kernel
(the flash kernel has no backward yet). Serving: `prefill_attention` and
`decode_attention` go through the flash-attention op, which is the Hopper
kernel for CUDA tensors and its plain version for CPU tensors. All softmax
math is fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd), each KV head repeated in place
    (jnp.repeat order: kv head j serves q heads j*rep .. j*rep+rep-1)."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def _mask(iq: torch.Tensor, jk: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    ok = torch.ones((iq.shape[0], jk.shape[0]), dtype=torch.bool,
                    device=iq.device)
    if causal:
        ok = ok & (jk[None, :] <= iq[:, None])
    if window > 0:
        ok = ok & (jk[None, :] > iq[:, None] - window)
    return ok


def direct_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (B,Sq,H,hd). The quadratic
    path is the flash op's plain version, over every key."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 256, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online softmax over KV blocks inside a loop over Q blocks; every KV
    block is visited (fully masked ones add nothing).
    q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (B,Sq,H,hd)."""
    if window > 0:
        raise NotImplementedError(
            "windowed chunked attention comes with the local:global slice")
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    pad_q = (-Sq) % q_chunk
    pad_kv = (-Skv) % kv_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    # (n, B, H, chunk, hd) blocks
    qb = q.reshape(B, nq, q_chunk, H, hd).permute(1, 0, 3, 2, 4)
    kb = k.reshape(B, nkv, kv_chunk, H, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nkv, kv_chunk, H, hd).permute(1, 0, 3, 2, 4)
    dev = q.device
    outs = []
    for qi in range(nq):
        blk = qb[qi].float()
        iq = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for kvj in range(nkv):
            jk = kvj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", blk, kb[kvj].float()) * scale
            ok = _mask(iq, jk, causal, window) & (jk < Skv)[None, :]
            s = torch.where(ok[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb[kvj].float())
            m = m_new
        outs.append(acc / l.clamp(min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        B, nq * q_chunk, H, hd)
    return out[:, :Sq].to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, chunked_threshold: int = 1024
              ) -> torch.Tensor:
    if q.shape[1] <= chunked_threshold and k.shape[1] <= chunked_threshold:
        return direct_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


# ----------------------------------------------------------------------------
# serving: forward only, through the flash-attention kernel
# ----------------------------------------------------------------------------

def prefill_attention(q, k, v) -> torch.Tensor:
    """Causal attention of a prompt over its own keys (prefill).
    q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd)."""
    return flash_attention(q, k, v, causal=True)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token attention against a (B, Smax, KV, hd) cache holding
    entries [0, pos]: the flash op with Sq=1, q_offset=pos and kv_len=pos+1
    (the mask jk <= pos of the JAX function), reading only the filled part
    of the cache. q: (B,1,H,hd) -> (B,1,H,hd)."""
    return flash_attention(q, k_cache, v_cache, causal=True, q_offset=pos,
                           kv_len=pos + 1)
