#!/usr/bin/env python3
"""Time designs of chunk_reduce's in-place pair form on one CUDA card, in
turns, at the training path's shape.

    python3 tools/chunk_reduce_pairs_variants.py [--parent DIR] [--rounds N]

The shape is one degraded reduce-scatter hop of qwen3-1.7b's DP sync at
p = 4 with straggler 1: 3 pairs of fp32 rows of C = 573,524,992 elements
(the 1,720,574,976-element gradient padded and cut in 3) in a (12, C)
buffer (27.5 GB). The designs:

  parent          - the parent commit's kernel, built from DIR (default
                    build/parent/src: unpack the parent there first, e.g.
                    `git archive HEAD^ src | tar -x -C build/parent`)
  regs            - this checkout's kernel (one-shot CTAs of 256 threads x
                    8 16-byte vectors), and edited copies of its source
                    (EDITS: 4 or 2 vectors a thread, 512 threads x 4, loads
                    or stores without the streaming cache hint)
  bulk_<s>x<t>k   - the ring of bulk copies walked by persistent CTAs in
                    tools/chunk_reduce_pairs_ring.cu: s stages of t KB
                    tiles (s 2 / 3 / 4, t 8 / 16 / 32; 4 x 32 KB does not
                    fit in shared memory), two CTAs an SM where two fit
  add_            - three `buf[d].add_(buf[s])` calls (PyTorch's kernel)

and, after them, the W-way form at the healthy psum's shape (4, 1.72e9)
bf16: the parent's kernel and this checkout's (`wway_parent`, `wway`).

Each design is first run once on restored rows and held against the plain
sum (max abs error, bit-equality); then each round times every design by
CUDA events over 10 launches after 2 warm-up launches, in forward order in
odd rounds and reverse order in even ones. One JSON line per timing, then
one line of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import sys

import _variants

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_GRAD = 1_720_574_976          # qwen3-1.7b's parameters
PAIR_SRC = "repro_torch/kernels/chunk_reduce/csrc/chunk_reduce.cu"
RING_SRC = ROOT / "tools" / "chunk_reduce_pairs_ring.cu"
SMEM_PER_SM = 233472            # 228 KB per Hopper SM, 1 KB of it kept per CTA
# variant -> [(text, replacement)] in chunk_reduce.cu
EDITS = {
    "regs_v4": [("constexpr int kVecs = 8;", "constexpr int kVecs = 4;")],
    "regs_v2": [("constexpr int kVecs = 8;", "constexpr int kVecs = 2;")],
    "regs_v4_t512": [("constexpr int kVecs = 8;", "constexpr int kVecs = 4;"),
                     ("constexpr int kThreads = 256;",
                      "constexpr int kThreads = 512;")],
    "regs_plain_st": [("if (i < nvec) __stcs(out + i, add16<T>(a[u], b[u]));",
                       "if (i < nvec) out[i] = add16<T>(a[u], b[u]);")],
    "regs_plain_ld": [("      a[u] = __ldcs(d + i);\n      b[u] = __ldcs(r + i);",
                       "      a[u] = d[i];\n      b[u] = r[i];")],
}


def rounds_of(torch, fns: dict, rounds: int, shape: str) -> dict:
    times = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            ms = _variants.event_ms(torch, fns[name], 10)
            times[name].append(ms)
            print(json.dumps({"round": r, "variant": name, "shape": shape,
                              "ms": ms}), flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build/parent/src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch import _build
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    parent_src = pathlib.Path(args.parent) / PAIR_SRC
    if not parent_src.exists():
        raise SystemExit(f"{parent_src} not found: unpack the parent first")
    out_dir = ROOT / "build" / "variants"
    sources = {"pairs_parent": parent_src, "regs": ROOT / "src" / PAIR_SRC,
               "ring": RING_SRC,
               **_variants.write_edits(ROOT / "src" / PAIR_SRC, EDITS,
                                       out_dir)}
    _build.build_files(sources, out_dir)
    libs = {n: ctypes.CDLL(str(out_dir / f"lib{n}.so")) for n in sources}
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for lib in libs.values():
        lib.chunk_reduce_pairs.argtypes = [ptr] * 3 + [i64] * 3 + [ptr]
        lib.chunk_reduce_pairs.restype = ctypes.c_int
        lib.chunk_reduce.argtypes = [ptr, ptr] + [i64] * 4 + [ptr]
        lib.chunk_reduce.restype = ctypes.c_int
    ring = libs["ring"].chunk_reduce_pairs_ring
    ring.argtypes = [ptr] * 3 + [i64] * 6 + [ptr]
    ring.restype = ctypes.c_int
    _variants.print_card(torch)

    p, ph = 4, 3
    c = (N_GRAD + (-N_GRAD) % ph) // ph
    gen = torch.Generator(device="cuda").manual_seed(2)
    buf = torch.randn((p * ph, c), generator=gen, device="cuda")
    members = [0, 2, 3]          # healthy members with straggler 1
    dst = [members[(i + 1) % ph] * ph + i for i in range(ph)]
    src = [members[i] * ph + i for i in range(ph)]
    idx = torch.tensor([dst, src], dtype=torch.int64, device="cuda")
    keep = buf[dst].clone()
    want = keep + buf[src]
    stream = torch.cuda.current_stream().cuda_stream
    call = (buf.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(), ph, c, 0)

    def check(rc: int, what: str) -> None:
        if rc:
            raise SystemExit(f"{what}: cudaError_t {rc}")

    def pairs(name):
        def fn():
            check(libs[name].chunk_reduce_pairs(*call, stream), name)
        return fn

    def bulk(stages: int, kb: int):
        smem = 2 * stages * kb * 1024
        ctas_per_sm = 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1

        def fn():
            check(ring(*call, kb * 1024, stages, ctas_per_sm, stream),
                  f"ring {stages} x {kb} KB")
        return fn

    def library():
        for d, s in zip(dst, src):
            buf[d].add_(buf[s])

    fns = {"parent": pairs("pairs_parent"), "regs": pairs("regs")}
    fns.update({name: pairs(name) for name in EDITS})
    for stages in (2, 3, 4):
        for kb in (8, 16, 32):
            if 2 * stages * kb * 1024 <= 227 * 1024:
                fns[f"bulk_{stages}x{kb}k"] = bulk(stages, kb)
    fns["add_"] = library
    errors = {}
    for name, fn in fns.items():
        buf[dst] = keep
        fn()
        torch.cuda.synchronize()
        got = buf[dst]
        errors[name] = {"max_abs_err": float((got - want).abs().max()),
                        "bit_equal": bool(torch.equal(got, want))}
        print(json.dumps({"variant": name, **errors[name]}), flush=True)
    del keep, want, got
    times = rounds_of(torch, fns, args.rounds, f"pairs 3 x {c} fp32")
    del buf
    torch.cuda.empty_cache()

    parts = torch.randn((p, N_GRAD), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    out = torch.empty(N_GRAD, dtype=torch.bfloat16, device="cuda")

    def wway(name):
        def fn():
            check(libs[name].chunk_reduce(parts.data_ptr(), out.data_ptr(),
                                          p, N_GRAD, 1, 1, stream), name)
        return fn

    times.update(rounds_of(torch, {"wway_parent": wway("pairs_parent"),
                                   "wway": wway("regs")}, args.rounds,
                           f"W-way {p} x {N_GRAD} bf16"))
    print(json.dumps({"medians_ms": {k: statistics.median(v)
                                     for k, v in times.items()},
                      "errors": errors}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
