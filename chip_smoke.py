#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc into
`build/`, one nvcc per source, all started together), then runs these
phases, each printing one JSON line:

  kernels      - chunk_reduce's W-way and in-place pair forms against their
                 plain PyTorch versions on the card; the pair form to the
                 bit, at its edges (rows shorter than a vector, heads and
                 tails, one tile +- 1, views off 16-byte alignment);
  flash_kernel - the three flash-attention kernels against their plain
                 version, each case checked to take its route: on the
                 general route (flash_attention, tensor-core 3xTF32) the
                 JAX kernel tests' shapes (fp32/bf16, windows, non-causal),
                 fp32 at hd 64 / 128 (rep 1 / 2 / 4, ragged Sq, windows,
                 non-causal, q_offset), bf16 at hd 8 / 16 / 32, views off
                 16-byte alignment in both dtypes (prompts and <= 16 rows)
                 and qwen3-1.7b's fp32 prefill;
                 bf16 prompts at hd 64 / 128 (windows, non-causal, ragged
                 Sq, q_offset, rep 1 / 2 / 4) and qwen3-1.7b's bf16 prefill
                 on flash_prefill; decode steps (kv_len 1 .. 2111, rep
                 1 / 2 / 8, a window, 16 rows, fp32 and bf16, one split and
                 many) and qwen3-1.7b's decode on flash_decode;
  wkv_kernel   - wkv against its plain version: every head dim at S 1, 15,
                 16, 17, 33 and 1024 with and without an initial state, the JAX
                 sweep, state chaining over two calls, the rwkv6-7b prefill
                 shape and one-token decode steps chained from its final
                 state; it reports which cases were bit-equal;
  collectives  - psum, ring_allreduce and optcc_allreduce at p=4 against
                 x.sum(0), and the straggler's link count (Lemma 5);
  main_path    - `repro_torch.launch.train.main` on qwen3-1.7b at full width
                 through healthy -> degraded -> repaired steps;
  serve_qwen3  - `repro_torch.launch.serve.main` on qwen3-1.7b at full width
                 and depth (batch 8, prompt 2048, 64 new tokens);
  serve_rwkv6  - the same on rwkv6-7b (batch 4, prompt 1024, 32 new tokens);
  reference    - the DP step on the smoke config, card against CPU;
  serve_reference - both smoke configs: the card's greedy tokens equal the
                 CPU's (the fp32 qwen3 smoke prefill is the general
                 flash_attention route's path), and prefill/decode logits equal
                 `forward`'s;
  timing       - each kernel at its path's shapes (CUDA events, host
                 included, and `device_ms`: the kernels' own time from
                 torch.profiler) beside its bound, its plain version and one
                 PyTorch library call that computes the same function, where
                 there is one; wkv's decode step also with its inputs cold
                 in L2, rotating over 16 sets of inputs and states.

Each path (training, the two serve runs, the smoke configs' card run) is
driven with the kernels' launch counts set to 0 just before it and read
just after. Then it prints the
card's name and power limit (nvidia-smi), a `kernels` JSON line, and, as the
last line, {"ok": true, "device": {...}}. Any failed check raises: the
script exits nonzero and prints no result. It needs a CUDA card and the rest
of the repository; it imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
# fp32 attention: the faster of fp32 FMAs and three TF32 tensor-core
# products a plain product (3xTF32, fp32-accurate)
ATTN_FP32_FLOPS = max(FP32_FLOPS, TF32_FLOPS / 3)
FP32_TOL = 1e-6                    # |kernel - plain| <= 1e-6 * (1 + |plain|)
# flash_attention and wkv: |kernel - plain| <= tol * (1 + |plain|), the
# limits of the JAX kernel tests (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash_attention at qwen3-1.7b's serve shapes in bf16, where outputs are
# ~0.05 and 2e-2 would be far too wide: kernel and plain version both work
# in fp32 from the same bf16 inputs, so they may differ by the fp32 limit
# plus one bf16 rounding of the output: 2e-5 (1 + |plain|) + ulp_bf16(plain)
WKV_TOL = 1e-5
SERVE_TOL = 2e-4                   # tests/test_serve_equivalence.py
# a p-term fp32 sum in another association differs by at most
# 2 (p-1) 2^-24 sum|x_i| (3.6e-7 sum|x_i| at p=4); the limit is 1e-6 sum|x_i|
COLLECTIVE_TOL = 1e-6
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "chunk_reduce": ("src/repro_torch/kernels/chunk_reduce/csrc/"
                     "chunk_reduce.cu",
                     "src/repro/kernels/chunk_reduce/kernel.py:34"),
    "chunk_reduce_pairs": ("src/repro_torch/kernels/chunk_reduce/csrc/"
                           "chunk_reduce.cu",
                           "src/repro/kernels/chunk_reduce/kernel.py:34"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:68"),
    "flash_prefill": ("src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_prefill.cu",
                      "src/repro/kernels/flash_attention/kernel.py:68"),
    "flash_decode": ("src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_decode.cu",
                     "src/repro/kernels/flash_attention/kernel.py:68"),
    "wkv": ("src/repro_torch/kernels/wkv/csrc/wkv.cu",
            "src/repro/kernels/wkv/kernel.py:42"),
}
SERVE_QWEN3 = {"arch": "qwen3-1.7b", "batch": 8, "prompt_len": 2048,
               "new_tokens": 64}
SERVE_RWKV6 = {"arch": "rwkv6-7b", "batch": 4, "prompt_len": 1024,
               "new_tokens": 32}
FLASH_ROUTES = ("flash_attention", "flash_prefill", "flash_decode")
# the timing fields of each kernel in the `kernels` line
LINE_FIELDS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--dp", "4", "--seq-len", "128",
             "--global-batch", "8", "--steps", "6", "--fail-at", "2",
             "--repair-at", "4", "--straggler", "1", "--log-every", "1"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t = time.perf_counter()
    logs = _build.build_all()
    ptxas = {name: _ptxas_report(log) for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "ptxas": ptxas})
    # the pair form, wkv and the general flash route keep their operands in
    # registers by design: a spill there is a fault (a library built before
    # this run has no report)
    for entry in (ptxas.get("chunk_reduce", []) + ptxas.get("wkv", [])
                  + ptxas.get("flash_attention", [])):
        if entry["kernel"].startswith(("chunk_reduce_pairs", "wkv",
                                       "flash_tc")):
            require(entry["spill_bytes"] == 0,
                    f"{entry['kernel']} spills {entry['spill_bytes']} bytes")

    errs = {name: 0.0 for name in KERNELS}
    phase_kernels(torch, dev, errs)
    phase_flash_kernel(torch, dev, errs)
    phase_wkv_kernel(torch, dev, errs)
    phase_collectives(torch, dev)
    n_grad, launches = phase_main_path(torch, dev)
    launches.update(phase_serve(torch, dev, SERVE_QWEN3))
    launches.update(phase_serve(torch, dev, SERVE_RWKV6))
    phase_reference(torch, dev)
    launches.update(phase_serve_reference(torch, dev))
    timings = phase_timing(torch, dev, n_grad, errs)
    timings.update(phase_serve_timing(torch, dev, errs))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        require(launches[name] > 0, f"{name} never launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **timings[name]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _ptxas_report(log: str) -> list:
    """One entry per kernel of nvcc's `-Xptxas -v` output: its name (the
    mangled name cut to the function and its template arguments),
    registers, spill bytes (stores + loads) and static shared memory."""
    import re
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(r"\d+((?:chunk_reduce|flash|wkv)\w*?)"
                              r"(I\w*?E)?Ev", name)
            if short:
                args = re.findall(r"Li(\d+)E|Lb(\d)E|(f)(?=[EL])|(bfloat16)",
                                  short.group(2) or "")
                name = f"{short.group(1)}<{','.join(map(''.join, args))}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_bytes": spill,
                        "smem": int(smem.group(1)) if smem else 0})
            name, spill = None, 0
    return out


# ----------------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------------

def _ulp_bf16(torch, x):
    """One bf16 unit in the last place of each |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _compare(torch, got, want, what: str, tol: float | None = None,
             ulp: bool = False) -> float:
    """Max |got - want| over finite outputs of the same shape and dtype;
    raises past the limit: with `tol`, tol * (1 + |want|) (rtol = atol =
    tol, the JAX kernel tests' form), plus one bf16 ulp of |want| if `ulp`;
    without, that of want's dtype: 1e-6 (times 1 + |want|) for fp32, one
    bf16 ulp for bf16 (both sides accumulate in fp32, so only the final
    rounding may differ). Works in slices of 2^26 elements to bound the
    temporaries at the paths' sizes."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = 0.0
    step = 1 << 26
    for g, w in zip(got.reshape(-1).split(step), want.reshape(-1).split(step)):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        diff = (g - w).abs()
        if tol is not None:
            limit = tol * (1.0 + w.abs())
            bad = diff > (limit + _ulp_bf16(torch, w) if ulp else limit)
        elif want.dtype == torch.bfloat16:
            bad = diff > _ulp_bf16(torch, w)
        else:
            bad = diff > FP32_TOL * (1.0 + w.abs())
        err = max(err, float(diff.max()))
        require(not bool(bad.any()), f"{what}: max abs err {err} past the "
                "limit")
    return err


def phase_kernels(torch, dev, errs) -> None:
    from repro_torch.kernels.chunk_reduce import kernel, ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for out_dtype in (torch.float32, torch.bfloat16):
            for W in (1, 2, 4, 7, 16):
                for N in (128, 1000, 5001, 2 ** 24 + 3):
                    parts = torch.randn((W, N), generator=gen, device=dev,
                                        dtype=torch.float32).to(dtype)
                    got = ops.chunk_reduce(parts, out_dtype)
                    want = ref.chunk_reduce_ref(parts, out_dtype)
                    torch.cuda.synchronize()
                    errs["chunk_reduce"] = max(errs["chunk_reduce"], _compare(
                        torch, got, want, f"W-way {dtype}->{out_dtype} "
                        f"W={W} N={N}"))
                    cases += 1
        # pair form: the three moves of one reduce-scatter hop at p=4
        # (rows member*3 + chunk), plus a fold of a whole member row; rows
        # shorter than a vector, lengths that leave a head or tail in every
        # row, one tile +- 1, and views that start 1 or 3 elements past a
        # 16-byte boundary. Kernel and plain version add in fp32 and round
        # once, so they must agree to the bit.
        tile = kernel.PAIR_TILE_BYTES // torch.empty(
            (), dtype=dtype).element_size()
        for C in (1, 3, 4, 5, 128, 1000, 4097, 5001, tile - 1, tile,
                  tile + 1, 2 ** 22 + 1):
            for shift in (0, 1, 3):
                store = torch.randn(12 * C + shift, generator=gen,
                                    device=dev).to(dtype)
                buf = store[shift:].view(12, C)
                for dst, src in (([5, 9, 1], [4, 8, 0]),
                                 ([3, 4, 5], [0, 1, 2])):
                    want = buf.clone()
                    ref.chunk_reduce_pairs_ref_(want, dst, src)
                    ops.chunk_reduce_pairs_(buf, dst, src)
                    torch.cuda.synchronize()
                    what = f"pairs {dtype} C={C} shift={shift} dst={dst}"
                    errs["chunk_reduce_pairs"] = max(
                        errs["chunk_reduce_pairs"],
                        _compare(torch, buf, want, what))
                    require(torch.equal(buf, want), f"{what}: not bit-equal "
                            "to the plain version")
                    cases += 1
    emit({"phase": "kernels", "cases": cases,
          "max_abs_err": {k: errs[k] for k in ("chunk_reduce",
                                               "chunk_reduce_pairs")},
          "pairs_bit_equal": True})


# (B, Sq, Skv, H, KV, hd): tests/test_kernels.py's flash sweep
FLASH_SWEEP = [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
               (1, 48, 48, 4, 1, 32), (2, 40, 40, 2, 2, 8)]


def _qwen3_attn_shape():
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_QWEN3["arch"])
    return (SERVE_QWEN3["batch"], SERVE_QWEN3["prompt_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.hd)


def phase_flash_kernel(torch, dev, errs) -> None:
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(q, k, v, what, route, tight=False, **kw):
        """One call of the op against the plain version; it must have
        launched exactly `route`. `tight`: the qwen3-shape limit."""
        before = dict(kernel.launches)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = [n for n in FLASH_ROUTES if kernel.launches[n] != before[n]]
        require(ran == [route], f"{what}: launched {ran}, not {route}")
        bf16 = q.dtype == torch.bfloat16
        tol = FLASH_TOL["float32" if tight or not bf16 else "bfloat16"]
        err = _compare(torch, got, want, what, tol, ulp=tight and bf16)
        group = (f"{route} {'qwen3-limit' if tight else 'sweep'} "
                 f"{str(q.dtype)[6:]}")
        by_group[group] = max(by_group.get(group, 0.0), err)
        errs[route] = max(errs[route], err)

    cases = 0
    by_group = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, KV, hd in FLASH_SWEEP:
            q = rand((B, Sq, H, hd), dtype)
            k, v = rand((B, Skv, KV, hd), dtype), rand((B, Skv, KV, hd), dtype)
            check(q, k, v, f"sweep {dtype} {(B, Sq, H, KV, hd)}",
                  "flash_attention")
            cases += 1
        q = rand((2, 64, 4, 16), dtype)
        k, v = rand((2, 64, 2, 16), dtype), rand((2, 64, 2, 16), dtype)
        for window in (8, 24, 1000):
            check(q, k, v, f"window {window} {dtype}", "flash_attention",
                  window=window)
            cases += 1
        check(q, k, v, f"non-causal {dtype}", "flash_attention",
              causal=False)
        cases += 1
    # the general route (flash_attention), held to the fp32 limit (plus one
    # bf16 ulp): fp32 prompts at hd 64 / 128, rep 1 / 2 / 4, Sq 200 (not a
    # multiple of a CTA's 64 row slots), windows, non-causal, and a chunk
    # after a cached prefix; bf16 prompts at the small head dims; views off
    # 16-byte alignment in both dtypes, as a prompt and at <= 16 rows (an
    # unaligned decode step, 8 queries of rep 2)
    for hd in (64, 128):
        for rep in (1, 2, 4):
            KV = 2
            q = rand((2, 200, KV * rep, hd), torch.float32)
            k, v = (rand((2, 200, KV, hd), torch.float32),
                    rand((2, 200, KV, hd), torch.float32))
            for kw in ({}, {"window": 8}, {"window": 24}, {"window": 1000},
                       {"causal": False}):
                check(q, k, v, f"general fp32 hd {hd} rep {rep} {kw}",
                      "flash_attention", tight=True, **kw)
            q = rand((2, 130, KV * rep, hd), torch.float32)
            k, v = (rand((2, 340, KV, hd), torch.float32),
                    rand((2, 340, KV, hd), torch.float32))
            check(q, k, v, f"general fp32 hd {hd} rep {rep} q_offset 200",
                  "flash_attention", tight=True, q_offset=200, kv_len=330)
            cases += 6
    for hd in (8, 16, 32):
        for rep in (1, 2, 4):
            q = rand((2, 200, 2 * rep, hd), torch.bfloat16)
            k, v = (rand((2, 200, 2, hd), torch.bfloat16),
                    rand((2, 200, 2, hd), torch.bfloat16))
            for kw in ({}, {"window": 24}, {"causal": False}):
                check(q, k, v, f"general bf16 hd {hd} rep {rep} {kw}",
                      "flash_attention", tight=True, **kw)
                cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 64, 128):
            n = 2 * 300 * 2 * hd
            store = rand((n + 3,), dtype)
            k, v = store[1:1 + n].view(2, 300, 2, hd), \
                store[3:3 + n].view(2, 300, 2, hd)
            check(rand((2, 150, 4, hd), dtype), k, v,
                  f"general {dtype} hd {hd} unaligned prompt",
                  "flash_attention", tight=True)
            check(rand((2, 1, 4, hd), dtype), k, v,
                  f"general {dtype} hd {hd} unaligned decode",
                  "flash_attention", tight=True, q_offset=290, kv_len=291)
            check(rand((2, 8, 4, hd), dtype), k, v,
                  f"general {dtype} hd {hd} unaligned 16 rows",
                  "flash_attention", tight=True, q_offset=280, kv_len=288,
                  window=5)
            cases += 3
    # flash_prefill: bf16 prompts at hd 64 and 128, GQA rep 1 / 2 / 4, Sq
    # not a multiple of its 64-query tile; causal, windows, non-causal, and
    # a chunk of queries after a cached prefix (q_offset > 0, kv_len < Skv)
    bf = torch.bfloat16
    for hd in kernel.PREFILL_HEAD_DIMS:
        for rep in (1, 2, 4):
            KV = 2
            q = rand((2, 200, KV * rep, hd), bf)
            k, v = rand((2, 200, KV, hd), bf), rand((2, 200, KV, hd), bf)
            for kw in ({}, {"window": 8}, {"window": 24}, {"window": 1000},
                       {"causal": False}):
                check(q, k, v, f"prefill hd {hd} rep {rep} {kw}",
                      "flash_prefill", tight=True, **kw)
            q = rand((2, 130, KV * rep, hd), bf)
            k, v = rand((2, 340, KV, hd), bf), rand((2, 340, KV, hd), bf)
            check(q, k, v, f"prefill hd {hd} rep {rep} q_offset 200",
                  "flash_prefill", tight=True, q_offset=200, kv_len=330)
            cases += 6
    # flash_decode: one query over a cache of 2112 positions holding kv_len
    # keys, for kv_len around its 64-key tile and up to qwen3's last decode
    # step, rep 1 / 2 / 8, in both dtypes; a window; 16 rows (8 queries of a
    # speculative chunk, rep 2) with their own causal limits. The split
    # count runs from 1 (kv_len <= 64) to many.
    splits = set()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128):
            for rep in (1, 2, 8):
                B, KV = 4, 2
                kc = rand((B, 2112, KV, hd), dtype)
                vc = rand((B, 2112, KV, hd), dtype)
                q = rand((B, 1, KV * rep, hd), dtype)
                for kv_len in (1, 63, 64, 65, 2081, 2111):
                    check(q, kc, vc, f"decode {dtype} hd {hd} rep {rep} "
                          f"kv_len {kv_len}", "flash_decode",
                          tight=True, q_offset=kv_len - 1,
                          kv_len=kv_len)
                    splits.add(kernel.decode_splits(kv_len, B * KV, sms))
                    cases += 1
        check(q, kc, vc, f"decode {dtype} window 100", "flash_decode",
              tight=True, q_offset=2080, kv_len=2081, window=100)
        q = rand((B, 8, KV * 2, 128), dtype)
        check(q, kc, vc, f"decode {dtype} 8 queries rep 2", "flash_decode",
              tight=True, q_offset=2000, kv_len=2008)
        check(q, kc, vc, f"decode {dtype} 8 queries rep 2 window 3",
              "flash_decode", tight=True, q_offset=2000, kv_len=2008,
              window=3)
        # the same with one key per split (10 splits): each row sees no key
        # in most splits, whose partials the combine must skip
        min_keys, kernel.DECODE_MIN_KEYS = kernel.DECODE_MIN_KEYS, 1
        try:
            splits.add(kernel.decode_splits(10, B * KV, sms))
            check(q, kc, vc, f"decode {dtype} 8 queries window 3, 10 splits",
                  "flash_decode", tight=True, q_offset=2000,
                  kv_len=2008, window=3)
        finally:
            kernel.DECODE_MIN_KEYS = min_keys
        cases += 4
    require(min(splits) == 1 and max(splits) > 1,
            f"decode split counts {sorted(splits)}: want 1 and many")
    # qwen3-1.7b's serve shapes (hd 128, GQA 16/8): the prefill, and decode
    # steps over the cache at a few positions; bf16 as the model runs, and
    # fp32, both held to the fp32 limit (bf16 plus one output rounding)
    B, S, H, KV, hd = _qwen3_attn_shape()
    positions = sorted({0, 1, min(1000, S - 1), S - 1})
    for dtype, route in ((torch.bfloat16, "flash_prefill"),
                         (torch.float32, "flash_attention")):
        q = rand((B, S, H, hd), dtype)
        k, v = rand((B, S, KV, hd), dtype), rand((B, S, KV, hd), dtype)
        check(q, k, v, f"qwen3 prefill {dtype}", route, tight=True)
        del q, k, v
        kc = rand((B, S + SERVE_QWEN3["new_tokens"], KV, hd), dtype)
        vc = rand((B, S + SERVE_QWEN3["new_tokens"], KV, hd), dtype)
        q = rand((B, 1, H, hd), dtype)
        for pos in positions:
            check(q, kc, vc, f"qwen3 decode pos={pos} {dtype}",
                  "flash_decode", tight=True, q_offset=pos,
                  kv_len=pos + 1)
        cases += 1 + len(positions)
        del kc, vc, q
        torch.cuda.empty_cache()
    emit({"phase": "flash_kernel", "cases": cases,
          "max_abs_err": {r: errs[r] for r in FLASH_ROUTES},
          "by_group": by_group, "decode_splits": sorted(splits),
          "limits": {**FLASH_TOL, "qwen3-limit": "2e-5 (1 + |plain|) + "
                     "one bf16 ulp of |plain| in bf16"}})


def _wkv_inputs(torch, gen, dev, B, S, H, hd):
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
               for _ in range(3))
    w = 0.2 + 0.79 * torch.rand((B, S, H, hd), generator=gen, device=dev)
    u = torch.randn((H, hd), generator=gen, device=dev)
    return r, k, v, w, u


def _rwkv6_wkv_shape():
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_RWKV6["arch"])
    hd = cfg.ssm_state
    return (SERVE_RWKV6["batch"], SERVE_RWKV6["prompt_len"],
            cfg.d_model // hd, hd)


def phase_wkv_kernel(torch, dev, errs) -> None:
    from repro_torch.kernels.wkv import kernel, ops, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    bit_equal = {}

    def check(got, want, what):
        torch.cuda.synchronize()
        for g, w, part in zip(got, want, ("out", "state")):
            errs["wkv"] = max(errs["wkv"], _compare(
                torch, g, w, f"{what} {part}", WKV_TOL))
        bit_equal[what] = all(torch.equal(g, w) for g, w in zip(got, want))

    cases = 0
    # every head dim: one token, prompts around 16 tokens, past one staged
    # chunk (33 > WKV_CHUNK) and long; from a zero and from a random state
    for hd in kernel.HEAD_DIMS:
        for S in (1, 15, 16, 17, 33, 1024):
            x = _wkv_inputs(torch, gen, dev, 2, S, 3, hd)
            s0 = torch.randn((2, 3, hd, hd), generator=gen, device=dev)
            for state0 in (None, s0):
                check(ops.wkv(*x, state0), ref.wkv_ref(*x, state0),
                      f"hd {hd} S {S} state0 {state0 is not None}")
                cases += 1
    for shape in ((1, 16, 2, 8), (2, 33, 3, 16), (1, 64, 1, 32),
                  _rwkv6_wkv_shape()):
        x = _wkv_inputs(torch, gen, dev, *shape)
        got = ops.wkv(*x)
        check(got, ref.wkv_ref(*x), f"shape {shape}")
        cases += 1
    # rwkv6-7b's decode: one-token calls from the prefill's final state,
    # each fed the state the previous call returned (kernel and plain
    # version chained on their own)
    B, _, H, hd = _rwkv6_wkv_shape()
    st_got = st_want = got[1]
    for step in range(4):
        x1 = _wkv_inputs(torch, gen, dev, B, 1, H, hd)
        got, want = ops.wkv(*x1, st_got), ref.wkv_ref(*x1, st_want)
        check(got, want, f"rwkv6 decode step {step}")
        st_got, st_want = got[1], want[1]
        cases += 1
    del x, x1, got, want, st_got, st_want
    # two calls chained through the state equal one call and the plain
    # version given the same initial state
    B, S, H, hd = 1, 32, 2, 8
    r, k, v, w, u = _wkv_inputs(torch, gen, dev, B, S, H, hd)
    full = ops.wkv(r, k, v, w, u)
    _, st1 = ops.wkv(*(t[:, :16].contiguous() for t in (r, k, v, w)), u)
    second = [t[:, 16:].contiguous() for t in (r, k, v, w)]
    out2 = ops.wkv(*second, u, st1)
    check(out2, ref.wkv_ref(*second, u, st1), "chained, second call")
    check(out2, (full[0][:, 16:].contiguous(), full[1]), "chained vs one")
    cases += 2
    torch.cuda.empty_cache()
    emit({"phase": "wkv_kernel", "cases": cases, "max_abs_err": errs["wkv"],
          "limit": WKV_TOL, "all_bit_equal": all(bit_equal.values()),
          "bit_equal": bit_equal})


def phase_collectives(torch, dev) -> None:
    from repro_torch.comms import (LocalTransport, optcc_allreduce, psum,
                                   ring_allreduce)
    p = 4
    tr = LocalTransport(p)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for n in (1000, 1001, 2 ** 20 + 1):
        x = torch.randn((p, n), generator=gen, device=dev)
        out[f"psum n={n}"] = _close(torch, psum(x), x)
        if n % p == 0:
            out[f"ring n={n}"] = _close(torch, ring_allreduce(x, tr), x)
        for s in (0, 1, 3):
            tr.reset_counts()
            got = optcc_allreduce(x, s, tr)
            out[f"optcc s={s} n={n}"] = _close(torch, got, x)
            npad = n + (-n) % (p - 1)
            require(tr.link_load(s) == 2 * npad,
                    f"straggler {s} link carried {tr.link_load(s)} elements, "
                    f"not 2 x {npad}")
    emit({"phase": "collectives", "p": p, "max_abs_err": out,
          "straggler_link": "2 x padded length"})


def _close(torch, got, x) -> float:
    """Max |got - x.sum(0)| over every member's row; raises past
    COLLECTIVE_TOL * sum|x_i| (+ the same absolute floor)."""
    diff = (got - x.sum(0)).abs()
    bad = diff > COLLECTIVE_TOL * (1.0 + x.abs().sum(0))
    err = float(diff.max())
    require(not bool(bad.any()), f"collective off by up to {err}")
    return err


def phase_main_path(torch, dev):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    state, log = train_main(MAIN_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launch_counts()
    launches = {k: counts[k] for k in ("chunk_reduce", "chunk_reduce_pairs")}
    n_grad = sum(v.numel() for v in state.params.values())
    depth = state.params["blocks/wq"].shape[0]
    for rec in log:
        emit({"phase": "main_step", **rec})
        require(math.isfinite(rec["loss"]), f"step {rec['step']}: loss "
                f"{rec['loss']}")
        require(math.isfinite(rec["grad_norm"]), f"step {rec['step']}: "
                f"grad norm {rec['grad_norm']}")
    healthy = [r for r in log if r["sync"] == "psum"]
    degraded = [r for r in log if r["sync"] == "optcc"]
    require(healthy and degraded, "the run did not see both sync kinds")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in healthy),
            "a healthy step did not launch chunk_reduce")
    require(all(r["launches"]["chunk_reduce_pairs"] > 0 for r in degraded),
            "a degraded step did not launch chunk_reduce_pairs")
    emit({"phase": "main_path", "argv": MAIN_ARGV, "n_layers": depth,
          "params": n_grad, "seconds": seconds, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del state
    torch.cuda.empty_cache()
    return n_grad, launches


def _serve_kernels(cfg, n_new: int) -> dict:
    """The launches a generate run of n_new tokens must make: one per layer
    in the prefill and in each of the n_new - 1 decode steps; for qwen3 in
    bf16 at hd 128, the prefill on flash_prefill, the decode steps on
    flash_decode and none on the general flash_attention route."""
    if cfg.family == "rwkv6":
        return {"wkv": cfg.n_layers * n_new}
    return {"flash_attention": 0, "flash_prefill": cfg.n_layers,
            "flash_decode": cfg.n_layers * (n_new - 1)}


def phase_serve(torch, dev, spec: dict) -> dict:
    """`launch.serve.main` at full width and depth; returns the launches
    of the path's kernels in that run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import main as serve_main
    cfg = get_config(spec["arch"])
    argv = ["--arch", spec["arch"], "--batch", str(spec["batch"]),
            "--prompt-len", str(spec["prompt_len"]),
            "--new-tokens", str(spec["new_tokens"]), "--seed", "0"]
    reset_launch_counts()
    tokens, log = serve_main(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = _serve_kernels(cfg, spec["new_tokens"])
    launches = {k: counts[k] for k in want}
    require(tuple(tokens.shape) == (spec["batch"], spec["new_tokens"]),
            f"{cfg.name}: tokens {tuple(tokens.shape)}")
    require(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
            f"{cfg.name}: a token outside the vocabulary")
    require(log["logits_finite"], f"{cfg.name}: non-finite logits")
    require(launches == want, f"{cfg.name}: launches {launches}, not "
            f"{want} (one per layer per prefill and decode step)")
    emit({"phase": "serve_" + spec["arch"].split("-")[0], "argv": argv,
          **log, "kernel_launches": launches})
    del tokens
    torch.cuda.empty_cache()
    return launches


def phase_reference(torch, dev) -> None:
    """Smoke config, same parameters on the card and on the CPU: the card's
    degraded (OptCC) run equals its healthy (psum) run, as on 8 JAX devices
    in tests/multidev_driver.py, and the CPU's plain-PyTorch run."""
    from repro_torch.comms import LocalTransport
    from repro_torch.comms.fault import FaultState
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.schedules import constant
    from repro_torch.train import TrainState, make_dp_failover_step

    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    opt = AdamWConfig(weight_decay=0.0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8))
    init = model.init(7, "cpu")
    runs = {}
    for name, device, fault in (
            ("cuda_healthy", dev, FaultState(4)),
            ("cuda_degraded", dev, FaultState(4, straggler=1, ell=1.5)),
            ("cpu_degraded", torch.device("cpu"),
             FaultState(4, straggler=1, ell=1.5))):
        params = {k: v.detach().clone().to(device) for k, v in init.items()}
        state = TrainState(params, init_state(params, opt), 0)
        step = make_dp_failover_step(model, LocalTransport(4), opt,
                                     constant(1e-3), fault)
        losses = []
        for i in range(3):
            batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                     for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs[name] = (losses, {k: v.detach().cpu() for k, v in
                               state.params.items()})

    def gap(a, b):
        dl = max(abs(x - y) / abs(y) for x, y in zip(runs[a][0], runs[b][0]))
        dp = max(float((runs[a][1][k] - runs[b][1][k]).abs().max())
                 for k in runs[a][1])
        return dl, dp

    hd = gap("cuda_degraded", "cuda_healthy")
    cd = gap("cuda_degraded", "cpu_degraded")
    # healthy vs degraded on one card: the limits of the JAX multidev check;
    # card vs CPU: rel 1e-5 loss, abs 1e-4 params (AdamW divides by sqrt(nu)
    # per element, so a float-order difference in a near-zero gradient grows
    # into an update difference of up to lr)
    require(hd[0] < 1e-5 and hd[1] < 1e-5, f"healthy vs degraded: {hd}")
    require(cd[0] < 1e-5 and cd[1] < 1e-4, f"card vs CPU: {cd}")
    emit({"phase": "reference", "config": cfg.name,
          "losses": {k: v[0] for k, v in runs.items()},
          "healthy_vs_degraded": {"loss_rel": hd[0], "params_abs": hd[1]},
          "card_vs_cpu": {"loss_rel": cd[0], "params_abs": cd[1]}})


def phase_serve_reference(torch, dev) -> dict:
    """Both smoke configs, the same parameters on the card and on the CPU:
    greedy tokens equal, and on the card the prefill logits and every
    decode step's logits equal `forward`'s at the same position. The fp32
    qwen3 smoke prefill (hd 16) is the general flash_attention route's path:
    returns its launches in the card's generate run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, rwkv6, transformer
    from repro_torch.train.serve import generate, pad_cache_to
    out = {}
    B, prompt_len, total = 2, 12, 24
    for arch in ("qwen3-1.7b", "rwkv6-7b"):
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        cpu_params = model.init(5, "cpu")
        params = {k: v.to(dev) for k, v in cpu_params.items()}
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, total))).long()
        want = generate(model, cpu_params, toks[:, :prompt_len], 8)
        reset_launch_counts()
        got = generate(model, params, toks[:, :prompt_len].to(dev), 8)
        torch.cuda.synchronize()
        counts = launch_counts()
        require(torch.equal(got.cpu(), want), f"{cfg.name}: card tokens "
                f"{got.tolist()} != CPU tokens {want.tolist()}")
        if cfg.family == "dense":
            # fp32 prompt, 24 rows per kv head: the general route
            n_cuda_core = counts["flash_attention"]
            expect = {"flash_attention": cfg.n_layers, "flash_prefill": 0,
                      "flash_decode": cfg.n_layers * 7}
            require({k: counts[k] for k in expect} == expect,
                    f"{cfg.name}: launches {counts}, not {expect}")
        toks = toks.to(dev)
        with torch.no_grad():
            if cfg.family == "rwkv6":
                h, w = rwkv6.forward(cfg, params, toks), params["lm_head"]
            else:
                h = transformer.forward(cfg, params, toks)
                w = transformer.unembed_matrix(cfg, params)
            full = h.float() @ w.float()
            logits, cache = model.prefill(params,
                                          {"tokens": toks[:, :prompt_len]})
            err = _compare(torch, logits, full[:, prompt_len - 1],
                           f"{cfg.name} prefill vs forward", SERVE_TOL)
            cache = pad_cache_to(cache, total)
            for pos in range(prompt_len, total):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
                err = max(err, _compare(
                    torch, lg, full[:, pos],
                    f"{cfg.name} decode vs forward at {pos}", SERVE_TOL))
        out[cfg.name] = {"tokens_equal": True, "logits_max_abs_err": err}
    emit({"phase": "serve_reference", "limit": SERVE_TOL, **out,
          "flash_attention_launches": n_cuda_core})
    return {"flash_attention": n_cuda_core}


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------

def _cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# name -> what the profiler calls its kernels (each name is a substring)
KERNEL_SYMBOLS = {"chunk_reduce": "chunk_reduce_kernel",
                  "chunk_reduce_pairs": "chunk_reduce_pairs_",
                  "flash_attention": "flash_tc_kernel",
                  "flash_prefill": "flash_prefill_kernel",
                  "flash_decode": "flash_decode_",
                  "wkv": "wkv_kernel"}


def _device_ms(torch, fn, iters: int, kernel: str) -> float:
    """The device time per call of `kernel`'s CUDA kernels, from
    torch.profiler's record of `iters` calls after one warm-up call: the
    kernels alone, without the host's work between launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if KERNEL_SYMBOLS[kernel] in e.key)
    require(us > 0, f"the profiler recorded no device time for {kernel}")
    return us / iters / 1e3


def _bound(bytes_moved: int, flops: int, peak: float = FP32_FLOPS) -> dict:
    """Least time for the work: the larger of its bytes (each input read
    once, each output written once) at the memory rate and its operations
    at the card's peak for their type (fp32 by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(torch, dev, n_grad: int, errs) -> dict:
    """Both forms at the main path's shapes: the healthy step's W=4 psum of
    the bf16 gradient vector, and one degraded reduce-scatter hop (three
    fp32 chunk pairs of the padded vector, p=4, straggler 1)."""
    from repro_torch.kernels.chunk_reduce import ops, ref
    p, ph = 4, 3
    out = {}
    gen = torch.Generator(device=dev).manual_seed(2)

    parts = torch.randn((p, n_grad), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    got = ops.chunk_reduce(parts)
    errs["chunk_reduce"] = max(errs["chunk_reduce"], _compare(
        torch, got, ref.chunk_reduce_ref(parts), f"W-way at main shape"))
    del got
    out["chunk_reduce"] = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce(parts), 10),
        "device_ms": _device_ms(torch, lambda: ops.chunk_reduce(parts), 5,
                                "chunk_reduce"),
        "plain_ms": _cuda_ms(torch, lambda: ref.chunk_reduce_ref(parts), 5),
        **_bound((p + 1) * n_grad * parts.element_size(), (p - 1) * n_grad),
        "library_ms": _cuda_ms(torch, lambda: parts.sum(0), 10),
        "shape": [p, n_grad], "dtype": "bfloat16"}
    del parts
    torch.cuda.empty_cache()

    npad = n_grad + (-n_grad) % ph
    c = npad // ph
    buf = torch.randn((p * ph, c), generator=gen, device=dev)
    ring = [0, 2, 3]          # healthy members with straggler 1
    dst = [ring[(i + 1) % ph] * ph + i for i in range(ph)]
    src = [ring[i] * ph + i for i in range(ph)]
    want = torch.stack([buf[d] + buf[s] for d, s in zip(dst, src)])
    ops.chunk_reduce_pairs_(buf, dst, src)
    errs["chunk_reduce_pairs"] = max(errs["chunk_reduce_pairs"], _compare(
        torch, buf[dst], want, "pairs at main shape"))
    require(torch.equal(buf[dst], want), "pairs at main shape: not "
            "bit-equal to the plain version")
    del want
    torch.cuda.empty_cache()

    def library():
        for d, s in zip(dst, src):
            buf[d].add_(buf[s])

    out["chunk_reduce_pairs"] = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce_pairs_(buf, dst, src),
                       10),
        "device_ms": _device_ms(
            torch, lambda: ops.chunk_reduce_pairs_(buf, dst, src), 5,
            "chunk_reduce_pairs"),
        "plain_ms": _cuda_ms(
            torch, lambda: ref.chunk_reduce_pairs_ref_(buf, dst, src), 5),
        **_bound(3 * ph * c * buf.element_size(), ph * c),
        "library_ms": _cuda_ms(torch, library, 10),
        "shape": [p * ph, c], "pairs": ph, "dtype": "float32",
        "bit_equal": True}
    del buf
    torch.cuda.empty_cache()
    emit({"phase": "timing", **out})
    return {k: {f: v[f] for f in LINE_FIELDS} for k, v in out.items()}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_timing(torch, q, k, v, out, *, route: str, q_offset: int,
                  kv_len: int, causal: bool, iters: int) -> dict:
    """One flash route at one shape: kernel, plain version, SDPA (the
    library call: GQA, causal only for the prefill) and the bound: q, the
    first kv_len keys and values, the output; 4 hd flops per visible
    (query, key) pair, at the tensor-core bf16 rate for bf16 inputs and at
    ATTN_FP32_FLOPS for fp32 ones (3xTF32), the bound by fp32 FMAs beside
    it (`bound_fp32_fma_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    require(kernel.pick_route(q, k, v) == route,
            f"timing: {route} is not the route of {tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    kk, vv = k[:, :kv_len], v[:, :kv_len]
    qt, kt, vt = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
    pairs = sum(min(kv_len, q_offset + i + 1) if causal else kv_len
                for i in range(Sq))
    flops = 4 * hd * H * B * pairs
    nbytes = _nbytes(q, kk, vv, out)
    if q.dtype == torch.bfloat16:
        bound = _bound(nbytes, flops, BF16_FLOPS)
    else:
        bound = _bound(nbytes, flops, ATTN_FP32_FLOPS)
        bound["bound_fp32_fma_ms"] = _bound(nbytes, flops)["bound_ms"]
    return {
        "ms": _cuda_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                       iters),
        "device_ms": _device_ms(
            torch, lambda: ops.flash_attention(q, k, v, **kw), 5, route),
        "plain_ms": _cuda_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3),
        **bound,
        "library_ms": _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal and Sq > 1, enable_gqa=True),
            iters),
        "shape": {"q": list(q.shape), "kv": [B, kv_len] + list(k.shape[2:]),
                  "q_offset": q_offset},
        "dtype": str(q.dtype).removeprefix("torch.")}


def _wkv_timing(torch, x, state0, out, iters: int) -> dict:
    """wkv at one shape: kernel (CUDA events over back-to-back calls of the
    op, host included, and its device time), plain version, no library call
    (no one PyTorch call computes the recurrence), and the bound: r, k, v,
    w, u, state0 in and out and the final state; 7 fp32 flops per state
    element per token."""
    from repro_torch.kernels.wkv import ops, ref
    B, S, H, hd = x[0].shape
    inputs = list(x) + ([state0] if state0 is not None else [])
    return {
        "ms": _cuda_ms(torch, lambda: ops.wkv(*x, state0), iters),
        "device_ms": _device_ms(torch, lambda: ops.wkv(*x, state0),
                                min(iters, 10), "wkv"),
        "plain_ms": _cuda_ms(torch, lambda: ref.wkv_ref(*x, state0), 1,
                             warmup=1),
        **_bound(_nbytes(*inputs, *out), 7 * hd * hd * B * H * S),
        "library_ms": None,
        "shape": [B, S, H, hd], "state0": state0 is not None,
        "dtype": "float32"}


def phase_serve_timing(torch, dev, errs) -> dict:
    """The three flash routes at qwen3-1.7b's shapes: flash_prefill at the
    bf16 prefill, flash_decode at a mid-decode step, the general
    flash_attention route at the same prefill in fp32 (its route: fp32
    prompts), and the general route at the smoke configs' head dim at a
    realistic length, (8, 2048, 4/2, 16), in fp32 and bf16; wkv at
    rwkv6-7b's prefill and decode shapes. The `kernels` line takes
    flash_decode's decode shape, the general route's qwen3 fp32 prefill and
    wkv's prefill shape."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.wkv import ops as wops
    from repro_torch.kernels.wkv import ref as wref
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S, H, KV, hd = _qwen3_attn_shape()

    def rand(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    res = {}
    for name, dtype, route, (Hh, KVh, hdh), iters in (
            ("flash_prefill", torch.bfloat16, "flash_prefill", (H, KV, hd),
             20),
            ("flash_attention", torch.float32, "flash_attention",
             (H, KV, hd), 10),
            ("flash_attention_hd16_float32", torch.float32,
             "flash_attention", (4, 2, 16), 20),
            ("flash_attention_hd16_bfloat16", torch.bfloat16,
             "flash_attention", (4, 2, 16), 20)):
        q, k, v = (rand((B, S, Hh, hdh), dtype),
                   rand((B, S, KVh, hdh), dtype),
                   rand((B, S, KVh, hdh), dtype))
        out = fops.flash_attention(q, k, v)
        errs[route] = max(errs[route], _compare(
            torch, out, fref.flash_attention_ref(q, k, v),
            f"timed prefill {name}", FLASH_TOL["float32"], ulp=True))
        res[name] = _flash_timing(torch, q, k, v, out, route=route,
                                  q_offset=0, kv_len=S, causal=True,
                                  iters=iters)
        del q, k, v, out
        torch.cuda.empty_cache()
    n_new = SERVE_QWEN3["new_tokens"]
    kc, vc = rand((B, S + n_new, KV, hd)), rand((B, S + n_new, KV, hd))
    q = rand((B, 1, H, hd))
    pos = S + n_new // 2
    out = fops.flash_attention(q, kc, vc, q_offset=pos, kv_len=pos + 1)
    errs["flash_decode"] = max(errs["flash_decode"], _compare(
        torch, out, fref.flash_attention_ref(q, kc, vc, q_offset=pos,
                                             kv_len=pos + 1),
        "timed decode", FLASH_TOL["float32"], ulp=True))
    res["flash_decode"] = _flash_timing(
        torch, q, kc, vc, out, route="flash_decode", q_offset=pos,
        kv_len=pos + 1, causal=True, iters=200)
    del kc, vc, q, out
    torch.cuda.empty_cache()

    Bw, Sw, Hw, hdw = _rwkv6_wkv_shape()
    x = _wkv_inputs(torch, gen, dev, Bw, Sw, Hw, hdw)
    out = wops.wkv(*x)
    for g, w, part in zip(out, wref.wkv_ref(*x), ("out", "state")):
        errs["wkv"] = max(errs["wkv"], _compare(
            torch, g, w, f"timed prefill {part}", WKV_TOL))
    res["wkv"] = _wkv_timing(torch, x, None, out, iters=10)
    x1 = _wkv_inputs(torch, gen, dev, Bw, 1, Hw, hdw)
    state0 = out[1]
    res["wkv_decode"] = _wkv_timing(torch, x1, state0, wops.wkv(*x1, state0),
                                    iters=50)
    del x, x1, out, state0
    # the decode step as serving finds it: a layer's state was last touched
    # 31 layers ago, so rotate over 16 sets of inputs and states (72 MB of
    # inputs, past the 50 MB L2); `device_ms` is then the kernel's own time
    # with its inputs cold, `cold_ms` the same calls by CUDA events
    sets = [(_wkv_inputs(torch, gen, dev, Bw, 1, Hw, hdw),
             torch.randn((Bw, Hw, hdw, hdw), generator=gen, device=dev))
            for _ in range(16)]
    turn = [0]

    def cold():
        x1, s1 = sets[turn[0] % len(sets)]
        turn[0] += 1
        return wops.wkv(*x1, s1)

    res["wkv_decode"].update(
        device_ms=_device_ms(torch, cold, 64, "wkv"),
        cold_ms=_cuda_ms(torch, cold, 64),
        warm_device_ms=res["wkv_decode"]["device_ms"], cold_sets=len(sets))
    del sets
    torch.cuda.empty_cache()
    emit({"phase": "serve_timing", **res})
    return {k: {f: v[f] for f in LINE_FIELDS}
            for k, v in res.items() if k in KERNELS}


if __name__ == "__main__":
    sys.exit(main())
