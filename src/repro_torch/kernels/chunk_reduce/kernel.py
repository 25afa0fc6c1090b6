"""ctypes wrappers of the Hopper chunk_reduce kernel (csrc/chunk_reduce.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with torch, launches on PyTorch's current stream, raises if the
launch returned a CUDA error, and adds one to its count in `launches`.

The pair form's tile schedule is pure functions here (`pairs_tiles`,
`pairs_tile`, `tile_split`) with the same formulas as the kernel, so the
CPU tests cover it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the pair form's tile: one CTA of 256 threads x 8 16-byte vectors
# (kTileBytes in the kernel)
PAIR_TILE_BYTES = 16 * 256 * 8

# kernel launches per entry point since the last reset_launches()
launches = {"chunk_reduce": 0, "chunk_reduce_pairs": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The library, its entry points typed once: every pointer and the
    stream as c_void_p, every int as c_int64, so ctypes never truncates
    them to 32 bits."""
    lib = _build.load("chunk_reduce")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.chunk_reduce.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr]
    lib.chunk_reduce.restype = ctypes.c_int
    lib.chunk_reduce_pairs.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.chunk_reduce_pairs.restype = ctypes.c_int
    return lib


def pairs_tiles(n_pairs: int, C: int, itemsize: int) -> int:
    """The pair form's tile count, one CTA each: every pair's row of C
    elements cut into PAIR_TILE_BYTES tiles."""
    return n_pairs * -(-C // (PAIR_TILE_BYTES // itemsize))


def pairs_tile(t: int, C: int, tile_elems: int) -> tuple[int, int, int]:
    """Tile t of the pair form -> (pair, element offset in the row,
    length)."""
    per_pair = -(-C // tile_elems)
    pair, i = divmod(t, per_pair)
    off = i * tile_elems
    return pair, off, min(tile_elems, C - off)


def tile_split(dst_addr: int, src_addr: int, length: int,
               itemsize: int) -> tuple[int, int, int]:
    """A tile's (head, body, tail) in elements: the body is the run of
    whole 16-byte vectors that starts 16-byte aligned on both sides; head
    and tail take the scalar path. Where dst and src sit at different
    offsets within 16 bytes, the tile is all head."""
    md, ms = dst_addr % 16, src_addr % 16
    if md != ms:
        return length, 0, 0
    head = min(length, (16 - md) % 16 // itemsize)
    vec = 16 // itemsize
    body = (length - head) // vec * vec
    return head, body, length - head - body


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def chunk_reduce_cuda(parts: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """(W, N) -> (N,) on the card: fp32 accumulation, one cast to
    `out_dtype` (default: the input's dtype). W from 1 to 16."""
    _check_cuda(parts, "parts")
    if parts.dim() != 2:
        raise ValueError(f"parts must be (W, N), got {tuple(parts.shape)}")
    W, N = parts.shape
    if not 1 <= W <= 16 or N < 1:
        raise ValueError(f"need 1 <= W <= 16 and N >= 1, got W={W} N={N}")
    out_dtype = out_dtype or parts.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    out = torch.empty(N, dtype=out_dtype, device=parts.device)
    rc = _lib().chunk_reduce(parts.data_ptr(), out.data_ptr(), W, N,
                             _DTYPE_CODE[parts.dtype],
                             _DTYPE_CODE[out_dtype], _stream(parts))
    _build.check(rc, "chunk_reduce launch")
    launches["chunk_reduce"] += 1
    return out


def chunk_reduce_pairs_cuda_(buf: torch.Tensor, dst: Sequence[int],
                             src: Sequence[int]) -> torch.Tensor:
    """In place on the card: buf[dst[j]] += buf[src[j]] for every j, rows
    of the (R, C) buffer; the caller has checked that the pairs are
    disjoint (ops.chunk_reduce_pairs_)."""
    _check_cuda(buf, "buf")
    if buf.dim() != 2:
        raise ValueError(f"buf must be (R, C), got {tuple(buf.shape)}")
    n_pairs, C = len(dst), buf.shape[1]
    if n_pairs < 1 or C < 1:
        raise ValueError(f"need a pair and a column, got {n_pairs} pairs "
                         f"of {C}")
    if pairs_tiles(n_pairs, C, buf.element_size()) >= 2 ** 31:
        raise ValueError(f"{n_pairs} pairs of {C} elements exceed the grid")
    idx = torch.tensor([list(dst), list(src)], dtype=torch.int64).to(
        buf.device, non_blocking=True)
    rc = _lib().chunk_reduce_pairs(buf.data_ptr(), idx[0].data_ptr(),
                                   idx[1].data_ptr(), n_pairs, C,
                                   _DTYPE_CODE[buf.dtype], _stream(buf))
    _build.check(rc, "chunk_reduce_pairs launch")
    launches["chunk_reduce_pairs"] += 1
    return buf
