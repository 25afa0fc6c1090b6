"""Public chunk_reduce ops: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, an error for anything else."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.chunk_reduce import kernel, ref


def chunk_reduce(parts: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum W partial buffers: (W, N) -> (N,), fp32 accumulation, one cast
    to `out_dtype` (default: the input's dtype)."""
    if parts.is_cuda:
        return kernel.chunk_reduce_cuda(parts, out_dtype)
    if parts.device.type == "cpu":
        return ref.chunk_reduce_ref(parts, out_dtype)
    raise ValueError(f"chunk_reduce runs on cuda or cpu, not {parts.device}")


def chunk_reduce_pairs_(buf: torch.Tensor, dst: Sequence[int],
                        src: Sequence[int]) -> torch.Tensor:
    """In place: buf[dst[j]] += buf[src[j]] for every pair j over the rows
    of the (R, C) buffer, fp32 accumulation rounded to buf's dtype.

    All pairs act at once, as the receives of one ppermute hop do, so no
    row may be both a destination and a source, and no destination may
    repeat; that is checked here on the host-side lists.
    """
    dst, src = [int(d) for d in dst], [int(s) for s in src]
    if len(dst) != len(src):
        raise ValueError("dst and src must have the same length")
    rows = buf.shape[0]
    if any(not 0 <= r < rows for r in dst + src):
        raise IndexError(f"row index out of range for {rows} rows")
    if len(set(dst)) != len(dst) or set(dst) & set(src):
        raise ValueError("pairs must be disjoint: distinct destination "
                         "rows, none of them a source row")
    if buf.is_cuda:
        return kernel.chunk_reduce_pairs_cuda_(buf, dst, src)
    if buf.device.type == "cpu":
        return ref.chunk_reduce_pairs_ref_(buf, dst, src)
    raise ValueError(f"chunk_reduce_pairs_ runs on cuda or cpu, not "
                     f"{buf.device}")
