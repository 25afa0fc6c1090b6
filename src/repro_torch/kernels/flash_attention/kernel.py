"""ctypes wrappers of the three Hopper flash-attention forward kernels, and
the rule that picks one of them for a call.

- `flash_decode` (csrc/flash_decode.cu): at most 16 rows per kv head
  (Sq x H / KV, a decode step), any dtype and head dim; the keys are split
  over CTAs and the partials combined in split order.
- `flash_prefill` (csrc/flash_prefill.cu): bf16 at hd 64 or 128, both
  products on the tensor cores (wgmma).
- `flash_attention` (csrc/flash_attention.cu): everything else (fp32
  prompts, the small head dims), fp32 FMAs on the CUDA cores.

`route` decides on the host, before any launch, from the dtype, the head
dim, the rows per kv head and the byte alignment of the addresses and
strides; it is a choice of kernel, not a fallback: a build or launch
failure raises. Each wrapper checks device, dtype, shapes and the last
dim's contiguity, passes the other strides through (so a layer's slice of
a KV cache is read in place), allocates the output (and the decode
kernel's workspace) with torch, launches on PyTorch's current stream,
raises if the launch returned a CUDA error, and adds one to
`launches[<its name>]`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)
PREFILL_HEAD_DIMS = (64, 128)   # flash_prefill's templates
DECODE_MAX_ROWS = 16            # flash_decode keeps a group's rows in registers
ALIGN = 16                      # bytes of one vector load / cp.async
# the decode split: about this many CTAs per SM (at qwen3-1.7b's decode on
# an H100, 2 a SM ran faster than 4 or 8), each over at least
# DECODE_MIN_KEYS keys (one tile), at most DECODE_MAX_SPLITS of them
DECODE_CTAS_PER_SM = 2
DECODE_MIN_KEYS = 64
DECODE_MAX_SPLITS = 64          # csrc/flash_decode.cu's kMaxSplits

# kernel launches since the last reset_launches()
launches = {"flash_attention": 0, "flash_prefill": 0, "flash_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def route(dtype: torch.dtype, hd: int, rows: int, byte_steps) -> str:
    """The kernel for one call. `rows` is Sq x H / KV (the query rows that
    share a kv head); `byte_steps` are the base addresses and the (batch,
    sequence, head) strides of q, k and v, in bytes. flash_prefill and
    flash_decode read 16-byte vectors, so they need every one of them
    aligned to 16."""
    aligned = all(int(s) % ALIGN == 0 for s in byte_steps)
    if rows <= DECODE_MAX_ROWS and aligned:
        return "flash_decode"
    if dtype == torch.bfloat16 and hd in PREFILL_HEAD_DIMS and aligned:
        return "flash_prefill"
    return "flash_attention"


def pick_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """`route` for these tensors (of any device: only shapes, dtype,
    addresses and strides are read)."""
    size = q.element_size()
    steps = [t.data_ptr() for t in (q, k, v)] + [
        s * size for t in (q, k, v) for s in t.stride()[:3]]
    return route(q.dtype, q.shape[3], q.shape[1] * (q.shape[2] // k.shape[2]),
                 steps)


def seen_keys(Sq: int, kv_len: int, *, causal: bool, window: int,
              q_offset: int) -> tuple[int, int]:
    """[lo, hi): the keys that some query row sees (the first row's window
    start to the last row's causal limit)."""
    hi = min(kv_len, q_offset + Sq) if causal else kv_len
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    return lo, hi


def decode_splits(n_keys: int, groups: int, sms: int) -> int:
    """How many CTAs share the keys of one (b, kv head) group in
    flash_decode: enough for DECODE_CTAS_PER_SM CTAs per SM over all
    `groups`, but none with fewer than DECODE_MIN_KEYS keys."""
    want = -(-DECODE_CTAS_PER_SM * sms // groups)
    return max(1, min(want, -(-n_keys // DECODE_MIN_KEYS), DECODE_MAX_SPLITS))


@functools.cache
def _entry(name: str):
    """The C entry point `<name>_fwd` of kernel library `name`, typed."""
    fn = getattr(_build.load(name), name + "_fwd")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    # B, Sq, H, KV, hd; 12 strides; q_offset, kv_len, window, causal; scale
    shape = [i64] * 5 + [i64] * 12 + [i64] * 4 + [ctypes.c_double]
    fn.argtypes = {
        "flash_attention": [ptr] * 4 + shape + [i64, ptr],
        "flash_prefill": [ptr] * 4 + shape + [ptr],
        "flash_decode": [ptr] * 5 + shape + [i64, i64, ptr],
    }[name]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    """Card `index`'s SM count (cudaDevAttrMultiProcessorCount)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, q_offset: int,
                         kv_len: int) -> torch.Tensor:
    """The kernel that `route` picks, on the card; see ops.flash_attention
    for the contract (the row precondition is checked there)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D with a contiguous last "
                             f"dim, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v must be on one device")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if B > 65535 or KV > 65535:
        raise ValueError("batch and kv heads must each be <= 65535")
    name = pick_route(q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    scale = 1.0 / float(np.sqrt(hd))
    common = (B, Sq, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], q_offset, kv_len, window,
              int(causal), scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    fn = _entry(name)
    if name == "flash_attention":
        rc = fn(*ptrs, *common, _DTYPE_CODE[q.dtype], stream)
    elif name == "flash_prefill":
        rc = fn(*ptrs, *common, stream)
    else:
        lo, hi = seen_keys(Sq, kv_len, causal=causal, window=window,
                           q_offset=q_offset)
        index = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        n_split = decode_splits(hi - lo, B * KV, _sms(index))
        # fp32 partials; freed on return, which is safe: the caching
        # allocator hands the block only to later work on this stream
        ws = None
        if n_split > 1:
            ws = torch.empty(B * KV * n_split * Sq * (H // KV) * (hd + 2),
                             dtype=torch.float32, device=q.device)
        rc = fn(*ptrs, ws.data_ptr() if ws is not None else None, *common,
                _DTYPE_CODE[q.dtype], n_split, stream)
    _build.check(rc, f"{name} launch")
    launches[name] += 1
    return out
