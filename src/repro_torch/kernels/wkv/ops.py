"""Public wkv op: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors, an error for anything else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv import kernel, ref


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rwkv6 recurrence, in fp32: r,k,v,w (B,S,H,hd), u (H,hd), an
    optional initial state (B,H,hd,hd) (zeros when None) -> (out (B,S,H,hd),
    final state (B,H,hd,hd)). Forward only."""
    if any(t is not None and t.requires_grad
           for t in (r, k, v, w, u, state0)):
        raise RuntimeError("wkv has no backward kernel yet: call it on "
                           "tensors that do not require grad")
    if r.is_cuda:
        return kernel.wkv_cuda(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return ref.wkv_ref(r, k, v, w, u, state0)
    raise ValueError(f"wkv runs on cuda or cpu, not {r.device}")
