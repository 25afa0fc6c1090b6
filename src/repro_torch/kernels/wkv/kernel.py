"""ctypes wrapper of the Hopper wkv kernel (csrc/wkv.cu).

The wrapper checks device, dtype, shapes and contiguity, allocates the
output and the final state with torch, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to
`launches["wkv"]`.

The launch plan (`wkv_plan`) and the thread -> (b, h, column, part) map
of the kernel (`wkv_thread_owner`) are pure functions here, so the CPU
tests cover them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import SMEM_PER_CTA

HEAD_DIMS = (8, 16, 32, 64)
WKV_CHUNK = 32             # tokens staged per chunk
WKV_STAGES = 2             # chunks in the cp.async ring (kStages in wkv.cu)
# for a prompt and for one token: state columns a thread holds (1 or 2),
# and CTAs per SM below which a CTA's columns are split. A prompt keeps
# whole heads (the fewest staged copies of r, k, w) and 2 columns a thread
# (each shared read serves both); one token wants more, smaller CTAs (its
# time is the latency of the state's loads and stores)
WKV_COLS_PER_THREAD = {"prompt": 2, "token": 1}
WKV_CTAS_PER_SM = {"prompt": 1, "token": 4}

# kernel launches since the last reset_launches()
launches = {"wkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _entry():
    """The C entry point wkv_fwd, typed once: 8 pointers, B, S, H, hd,
    cols, jc, chunk, the stream."""
    fn = _build.load("wkv").wkv_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    """Card `index`'s SM count (cudaDevAttrMultiProcessorCount)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def wkv_smem(hd: int, cols: int, chunk: int) -> int:
    """Shared memory of one CTA: per staged token r, k and w at hd + 16
    floats each (4 parts of hd/4 rows, padded by 4) and v of its cols,
    in each of the ring's WKV_STAGES stages."""
    return WKV_STAGES * chunk * (3 * (hd + 16) + cols) * 4


def wkv_plan(B: int, S: int, H: int, hd: int, sms: int) -> dict:
    """The kernel's launch: `cols` state columns per CTA, `jc` of them per
    thread, 4 threads a column; all hd columns in one CTA unless that
    leaves fewer than WKV_CTAS_PER_SM CTAs per SM, then halved while a CTA
    keeps whole warps (jc is lowered where hd is too narrow for a warp).
    WKV_CHUNK tokens are staged at a time (no more than the sequence
    has), in a ring of WKV_STAGES."""
    kind = "token" if S == 1 else "prompt"
    jc = WKV_COLS_PER_THREAD[kind]
    while jc > 1 and 4 * hd // jc % 32:
        jc //= 2
    cols = hd
    while 2 * cols // jc % 32 == 0 and B * H * (hd // cols) < \
            WKV_CTAS_PER_SM[kind] * sms:
        cols //= 2
    chunk = min(WKV_CHUNK, S)
    smem = wkv_smem(hd, cols, chunk)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"wkv plan needs {smem} B of shared memory")
    return {"cols": cols, "jc": jc, "chunk": chunk, "threads": 4 * cols // jc,
            "grid": (hd // cols, H, B), "smem": smem}


def wkv_thread_owner(plan: dict, bx, by, bz, tid, c: int = 0):
    """(b, h, column, part) of the c-th column (c < plan["jc"]) of thread
    `tid` of CTA (bx, by, bz), as the kernel computes them (works on ints
    and on integer numpy arrays): part p holds the state rows p, p + 4, ...
    of the column."""
    per = plan["cols"] // plan["jc"]
    return bz, by, bx * plan["cols"] + (tid >> 2) + c * per, tid & 3


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the card; see ops.wkv for the contract."""
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads must each be <= 65535")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(t, name, (B, S, H, hd))
    _check(u, "u", (H, hd))
    if state0 is not None:
        _check(state0, "state0", (B, H, hd, hd))
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("inputs must be on one device")
    index = r.device.index if r.device.index is not None \
        else torch.cuda.current_device()
    plan = wkv_plan(B, S, H, hd, _sms(index))
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    rc = _entry()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), out.data_ptr(),
        state.data_ptr(), B, S, H, hd, plan["cols"], plan["jc"],
        plan["chunk"], torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, "wkv launch")
    launches["wkv"] += 1
    return out, state
