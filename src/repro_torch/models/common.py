"""Shared building blocks: norms, RoPE, the SwiGLU MLP, embeddings, the
vocab-chunked loss and the dense init (the port of
`repro/models/common.py`'s dense-path functions)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


BLOCKS = "blocks/"      # path prefix of the stacked (L, ...) layer weights


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def layer_params(params: dict, layer: int) -> dict:
    """Layer `layer`'s slice of every stacked block weight, keyed by the
    path after "blocks/"."""
    return {k[len(BLOCKS):]: v[layer] for k, v in params.items()
            if k.startswith(BLOCKS)}


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, scaled by (1 + weight), cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ----------------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S). Rotates the split halves
    (x1, x2) of the head dim, not interleaved pairs."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (hd/2,)
    ang = positions[..., None].float() * freqs           # (B,S,hd/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Vocab-chunked softmax cross-entropy
# ----------------------------------------------------------------------------

def chunked_softmax_xent(h: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 256,
                         z_loss: float = 0.0) -> torch.Tensor:
    """Mean token NLL of labels under softmax(h @ w_out).

    h: (B, S, d); w_out: (d, V); labels: (B, S) int; label -100 = masked.
    Loops over sequence chunks (the sequence padded to a multiple of
    `chunk` with masked labels) so the fp32 logits are (B, chunk, V) at a
    time.
    """
    S = h.shape[1]
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
    w = w_out.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for c in range(h.shape[1] // chunk):
        hx = h[:, c * chunk:(c + 1) * chunk].float()
        lx = labels[:, c * chunk:(c + 1) * chunk]
        logits = hx @ w
        lse = torch.logsumexp(logits, dim=-1)
        mask = lx >= 0
        safe = torch.where(mask, lx, 0).long()
        gold = logits.gather(-1, safe[..., None])[..., 0]
        nll_sum = nll_sum + torch.where(mask, lse - gold, 0.0).sum()
        z_sum = z_sum + torch.where(mask, lse * lse, 0.0).sum()
        count = count + mask.sum()
    count = count.clamp(min=1)
    return nll_sum / count + z_loss * z_sum / count


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return embedding[tokens].to(compute_dtype)


def init_dense(shape: tuple, generator: torch.Generator,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(shape[0]) unless `scale` is given - as
    in the JAX package, shape[0] of a stacked (L, in, out) weight is L.
    Draws on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)
