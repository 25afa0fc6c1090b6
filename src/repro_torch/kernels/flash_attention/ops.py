"""Public flash_attention op: a CUDA kernel for CUDA tensors (which of the
three, `kernel.flash_attention_cuda` decides by `kernel.route`), the plain
PyTorch version for CPU tensors, on `meta` tensors only the count of the
kernel's work (the dry run), an error for anything else.

Forward only: there is no backward kernel yet, so an input that requires
grad is refused (training keeps `models/attention.attention`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.roofline import op_count


def check_rows_see_a_key(Sq: int, kv_len: int, *, causal: bool,
                         window: int, q_offset: int) -> None:
    """Raise unless every query row sees at least one key.

    Row i, at iq = q_offset + i, sees keys lo_i..hi_i with
    hi_i = min(kv_len - 1, iq) if causal else kv_len - 1 and
    lo_i = max(0, iq - window + 1) if window > 0 else 0. lo_i <= iq always,
    and lo_i grows with i, so every row sees a key exactly when the first
    row's hi is >= 0 and the last row's lo is <= kv_len - 1."""
    first_hi = min(kv_len - 1, q_offset) if causal else kv_len - 1
    last_lo = max(0, q_offset + Sq - window) if window > 0 else 0
    if first_hi < 0 or last_lo > kv_len - 1:
        raise ValueError(
            f"a query row sees no key (Sq={Sq}, kv_len={kv_len}, "
            f"causal={causal}, window={window}, q_offset={q_offset})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v with fp32 softmax statistics.

    q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (B,Sq,H,hd) in q's dtype. GQA:
    q head h reads kv head h // (H/KV). Query row i sits at q_offset + i;
    only keys jk < kv_len (default Skv) are read. Masks as in
    `ref.flash_attention_ref`."""
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} outside [1, {Skv}]")
    check_rows_see_a_key(q.shape[1], kv_len, causal=causal, window=window,
                         q_offset=q_offset)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward kernel yet: "
                           "call it on tensors that do not require grad")
    if q.is_cuda:
        return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           kv_len=kv_len)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len)
    if q.is_meta:
        # the dry run: the work of the kernel the card would launch, no
        # arithmetic (roofline.op_count)
        op_count.record(kernel.pick_route(q, k, v), *kernel.work(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_len=kv_len))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                     f"{q.device}")
