"""Plain PyTorch versions of chunk_reduce (the CPU path and the card's
yardstick for the CUDA kernel)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def chunk_reduce_ref(parts: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """parts: (W, N) -> (N,): fp32-accumulated elementwise sum, rows added
    in order (the kernel's association, so fp32 results agree to the bit;
    a library sum may associate the W terms differently)."""
    acc = parts[0].float().clone()
    for row in parts[1:]:
        acc.add_(row)
    return acc.to(out_dtype or parts.dtype)


def chunk_reduce_pairs_ref_(buf: torch.Tensor, dst: Sequence[int],
                            src: Sequence[int]) -> torch.Tensor:
    """In place on buf (R, C): buf[dst[j]] = buf[dst[j]] + buf[src[j]],
    added in fp32 and rounded to buf's dtype once."""
    for d, s in zip(dst, src):
        buf[d] = (buf[d].float() + buf[s].float()).to(buf.dtype)
    return buf
