"""Public wkv op: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors, on `meta` tensors only the count of the kernel's
work (the dry run), an error for anything else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv import kernel, ref
from repro_torch.roofline import op_count


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rwkv6 recurrence, in fp32: r,k,v,w (B,S,H,hd), u (H,hd), an
    optional initial state (B,H,hd,hd) (zeros when None) -> (out (B,S,H,hd),
    final state (B,H,hd,hd)). Forward only: training takes rwkv6's scan
    (`models.rwkv6._wkv_scan`), as the JAX package does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, w, u, state0)):
        raise RuntimeError("wkv has no backward kernel: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if r.is_cuda:
        return kernel.wkv_cuda(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return ref.wkv_ref(r, k, v, w, u, state0)
    if r.is_meta:
        # the dry run: the kernel's work, no arithmetic (roofline.op_count)
        op_count.record("wkv", *kernel.work(r, k, v, w, u, state0))
        B, S, H, hd = r.shape
        return (torch.empty((B, S, H, hd), device="meta"),
                torch.empty((B, H, hd, hd), device="meta"))
    raise ValueError(f"wkv runs on cuda, cpu or meta, not {r.device}")
