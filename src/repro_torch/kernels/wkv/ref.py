"""Plain PyTorch version of the rwkv6 wkv recurrence (the CPU path and the
card's yardstick for the CUDA kernel). Unlike the JAX package's jnp
`wkv_ref`, it takes the initial state."""
from __future__ import annotations

from typing import Optional

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            state0: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B, S, H, hd) fp32; u: (H, hd); state0: (B, H, hd, hd).

    For each token: kv = k_t^T v_t; out_t = r_t . (S + u * kv);
    S <- diag(w_t) S + kv. Returns (out (B,S,H,hd), final state).

    Each product and sum is its own rounded elementwise op, and the sum
    over k runs in the CUDA kernel's association: four partial sums over
    k = p, p+4, p+8, ... in order, then (s0 + s1) + (s2 + s3). So the
    kernel agrees with this version to the bit (hd must be a multiple of 4).
    """
    B, S, H, hd = r.shape
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
             if state0 is None else state0.float().clone())
    uk = u[None, :, :, None]
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,k,v)
        term = r[:, t, :, :, None] * (state + uk * kv)
        acc = term[:, :, 0:4]
        for i in range(4, hd, 4):
            acc = acc + term[:, :, i:i + 4]
        outs.append((acc[:, :, 0] + acc[:, :, 1])
                    + (acc[:, :, 2] + acc[:, :, 3]))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state
