"""Shared building blocks: norms, RoPE and Qwen2-VL's M-RoPE, the SwiGLU
MLP, embeddings, the vocab-chunked loss, the dense init and the chunked
time scan (the port of `repro/models/common.py`)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

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


def unbound_layers(params: dict, prefix: str = BLOCKS) -> list[dict]:
    """Every layer's weights under `prefix` ("blocks/", or whisper's
    "enc_blocks/" and "dec_blocks/"), keyed by the path after it, each
    stack unbound once (so autograd gathers a stacked weight's layer
    gradients in one op)."""
    stacks = {k[len(prefix):]: v.unbind(0) for k, v in params.items()
              if k.startswith(prefix)}
    n = len(next(iter(stacks.values())))
    return [{k: v[layer] for k, v in stacks.items()} for layer in range(n)]


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
# Rotary embeddings (standard + Qwen2-VL M-RoPE)
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


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> np.ndarray:
    """The (t, h, w) split of the hd/2 frequency channels: `sections`
    scaled to hd/2 (floored), the last taking the remainder."""
    half = head_dim // 2
    secs = np.asarray(sections, dtype=np.int64)
    secs = secs * half // secs.sum()
    secs[-1] = half - secs[:-1].sum()
    return secs


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x (B, S, H, hd); positions (B, S, 3) =
    (t, h, w) ids. Frequency channel c of the hd/2 is rotated by the id of
    its section (`mrope_sections`); text tokens carry equal ids in all
    three, which reduces it to `apply_rope`."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (hd/2,)
    sel = np.repeat(np.arange(3), mrope_sections(x.shape[-1], sections))
    pos = positions.float()[..., torch.from_numpy(sel).to(x.device)]
    ang = pos * freqs                                    # (B,S,hd/2)
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
    Draws on the generator's device in fp32, a stacked 3-D leaf one slice
    along dim 0 at a time and a 4-D one (L, E, in, out) one (layer,
    expert) slice at a time, each slice scaled in place and cast into the
    preallocated `dtype` result: the only fp32 temporary is one slice
    (0.46 GB for gemma3-27b's w_gate, whose whole leaf in fp32 would be
    28.7 GB; 0.14 GB for arctic-480b's experts, where one layer's would
    be 17.9 GB)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if len(shape) >= 4:
        pieces = out.reshape((-1,) + tuple(shape[-2:])).unbind(0)
    else:
        pieces = out.unbind(0) if len(shape) == 3 else (out,)
    for piece in pieces:
        piece.copy_(torch.randn(piece.shape, generator=generator,
                                dtype=torch.float32,
                                device=generator.device).mul_(scale))
    return out


def chunked_scan(chunk_fn: Callable, init, xs: Sequence[torch.Tensor],
                 chunk: int):
    """The time scan of JAX's `chunked_scan` as a plain loop over chunks.

    xs: tensors with a leading time axis of length S. As in JAX, the time
    axis is zero-padded to a multiple of `chunk` = min(chunk, S) and the
    padded steps run too, so the final carry is the one after them.
    `chunk_fn(carry, xs_chunk) -> (carry, ys_chunk)` runs one chunk's
    steps in order (JAX's inner `lax.scan`). JAX rematerializes each chunk
    in the backward; here autograd keeps every step (at the training
    path's seq 128 the scan is one chunk). Returns (carry, ys cut to S)."""
    S = xs[0].shape[0]
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    if pad:
        xs = [F.pad(a, (0, 0) * (a.dim() - 1) + (0, pad)) for a in xs]
    carry, ys = init, []
    for c0 in range(0, S + pad, chunk):
        carry, y = chunk_fn(carry, [a[c0:c0 + chunk] for a in xs])
        ys.append(y)
    return carry, torch.cat(ys)[:S]
