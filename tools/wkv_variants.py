#!/usr/bin/env python3
"""Time launch plans of the wkv kernel, edited copies of its source, and
the parent commit's kernel, on one CUDA card in turns, at rwkv6-7b's
serving shapes.

    python3 tools/wkv_variants.py [--parent DIR] [--rounds N]

DIR is the `src` directory of the parent commit (default
build/parent/src: unpack it there first, e.g.
`git archive HEAD^ src | tar -x -C build/parent`).

  prefill  (4, 1024, 64, 64) fp32 from a zero state: the parent, plans
           (cols, jc, chunk) of this checkout's kernel (the first of
           PREFILL_PLANS and of DECODE_PLANS is what the port's wkv_plan
           picks at these shapes), and edited copies of its source (EDITS:
           a ring of 3 stages, no pad, 4-byte shared reads, two tokens an
           iteration, no minimum of CTAs in the launch bounds) at the plans
           in EDIT_PLANS; CUDA events over 20
           launches after 2 warm-up launches.
  decode   (4, 1, 64, 64) fp32 with a state in and out, as serving finds
           it: the launches rotate over 16 sets of r, k, v, w and state
           (72 MB of inputs, past the 50 MB L2), each with its own outputs,
           so each one reads a cold state. `device_us` is the kernel's own
           time per launch from torch.profiler over 64 launches; `event_us`
           the same launches by CUDA events, host work between launches
           included. The plan wkv_plan picks is also timed with all 16 sets
           writing one pair of outputs (`_one_out`), as a caller whose
           allocator hands back the same block each time does.

Every variant is first held against the plain version (ref.py): its max
abs error and whether it is bit-equal. Rounds time every variant in
forward order, then in reverse order. One JSON line per timing, then one
line of medians.
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
WKV_SRC = "repro_torch/kernels/wkv/csrc/wkv.cu"
B, S, H, HD = 4, 1024, 64, 64     # rwkv6-7b serving: batch 4, prompt 1024
# (cols, jc, chunk)
PREFILL_PLANS = [(64, 2, 32), (64, 2, 16), (64, 1, 32), (32, 2, 32),
                 (64, 2, 8)]
DECODE_PLANS = [(16, 1, 1), (8, 1, 1), (32, 1, 1), (64, 1, 1), (16, 2, 1),
                (32, 2, 1), (64, 2, 1)]
# variant -> [(text, replacement)] in wkv.cu
EDITS = {
    # a ring of three staged chunks, not two
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # two tokens per iteration of the token loop, so the shared reads of
    # token t + 1 can issue during token t
    "unroll2": [("#pragma unroll 1\n    for (int t = 0; t < n; ++t) {",
                 "#pragma unroll 2\n    for (int t = 0; t < n; ++t) {")],
    # no pad between the four parts of a staged row (bank conflicts)
    "nopad": [("constexpr int PS = R + 4;", "constexpr int PS = R;")],
    # 4-byte shared reads of r, k, w instead of 16-byte ones
    "lds32": [("if constexpr (R % 4 == 0) {", "if constexpr (R < 0) {")],
    # ptxas left to pick its own register budget
    "no_min_blocks": [("__launch_bounds__(kMaxThreads, 1)",
                       "__launch_bounds__(kMaxThreads)")],
}
EDIT_PLANS = [(64, 2, 32), (64, 2, 16)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build/parent/src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch import _build
    from repro_torch.kernels.wkv import ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    parent_src = pathlib.Path(args.parent) / WKV_SRC
    if not parent_src.exists():
        raise SystemExit(f"{parent_src} not found: unpack the parent first")
    out_dir = ROOT / "build" / "variants"
    sources = {"wkv_parent": parent_src, "wkv_change": ROOT / "src" / WKV_SRC,
               **_variants.write_edits(ROOT / "src" / WKV_SRC, EDITS,
                                       out_dir, prefix="wkv_")}
    _build.build_files(sources, out_dir)
    libs = {n: ctypes.CDLL(str(out_dir / f"lib{n}.so")) for n in sources}
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    # the parent commit's entry point, without launch-plan arguments
    parent = libs.pop("wkv_parent").wkv_fwd
    parent.argtypes = [ptr] * 8 + [i64] * 4 + [ptr]
    parent.restype = ctypes.c_int
    change = {}
    for name, lib in libs.items():
        change[name.removeprefix("wkv_")] = fn = lib.wkv_fwd
        fn.argtypes = [ptr] * 8 + [i64] * 7 + [ptr]
        fn.restype = ctypes.c_int
    _variants.print_card(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(seq):
        r, k, v = (torch.randn((B, seq, H, HD), generator=gen, device="cuda")
                   for _ in range(3))
        w = 0.2 + 0.79 * torch.rand((B, seq, H, HD), generator=gen,
                                    device="cuda")
        u = torch.randn((H, HD), generator=gen, device="cuda")
        return r, k, v, w, u

    def caller(plan, x, s0, out, st):
        """A launch of the parent (plan None) or of `plan` = (cols, jc,
        chunk[, edit]) on x, s0 into out, st."""
        ptrs = [t.data_ptr() for t in x] + [
            None if s0 is None else s0.data_ptr(), out.data_ptr(),
            st.data_ptr()]
        seq = x[0].shape[1]
        extra = [] if plan is None else list(plan[:3])
        fn = parent if plan is None else change[
            plan[3] if len(plan) > 3 else "change"]

        def call():
            rc = fn(*ptrs, B, seq, H, HD, *extra, stream)
            if rc:
                raise SystemExit(f"plan {plan}: cudaError_t {rc}")
        return call

    def name_of(plan):
        if plan is None:
            return "parent"
        return "cols{}_jc{}_chunk{}".format(*plan[:3]) + "".join(
            "_" + e for e in plan[3:])

    def err(plan, x, s0):
        out, st = torch.empty_like(x[0]), torch.empty((B, H, HD, HD),
                                                      device="cuda")
        caller(plan, x, s0, out, st)()
        want = ref.wkv_ref(*x, s0)
        torch.cuda.synchronize()
        return {"max_abs_err": max(float((g - w).abs().max())
                                   for g, w in zip((out, st), want)),
                "bit_equal": all(bool(torch.equal(g, w))
                                 for g, w in zip((out, st), want))}

    times = {}
    # prefill
    x = inputs(S)
    out, st = torch.empty_like(x[0]), torch.empty((B, H, HD, HD),
                                                  device="cuda")
    plans = [None] + PREFILL_PLANS + [plan + (edit,) for edit in EDITS
                                      for plan in EDIT_PLANS]
    for plan in plans:
        print(json.dumps({"shape": "prefill", "variant": name_of(plan),
                          **err(plan, x, None)}), flush=True)
    for rnd in range(args.rounds):
        for plan in (plans if rnd % 2 == 0 else plans[::-1]):
            ms = _variants.event_ms(torch, caller(plan, x, None, out, st),
                                    20)
            key = "prefill " + name_of(plan)
            times.setdefault(key, []).append(ms)
            print(json.dumps({"round": rnd, "variant": key, "ms": ms}),
                  flush=True)
    del x, out, st

    # decode, cold: 16 sets of inputs and states, each with its outputs
    sets = []
    for _ in range(16):
        x1 = inputs(1)
        sets.append((x1, torch.randn((B, H, HD, HD), generator=gen,
                                     device="cuda"),
                     torch.empty_like(x1[0]),
                     torch.empty((B, H, HD, HD), device="cuda")))
    one_out, one_st = torch.empty_like(sets[0][2]), torch.empty_like(
        sets[0][3])
    variants = {name_of(plan): [caller(plan, *s) for s in sets]
                for plan in [None] + DECODE_PLANS}
    variants[name_of(DECODE_PLANS[0]) + "_one_out"] = [
        caller(DECODE_PLANS[0], x1, s0, one_out, one_st)
        for x1, s0, _, _ in sets]
    for plan in [None] + DECODE_PLANS:
        print(json.dumps({"shape": "decode", "variant": name_of(plan),
                          **err(plan, sets[0][0], sets[0][1])}), flush=True)
    for rnd in range(args.rounds):
        for name in (list(variants) if rnd % 2 == 0
                     else list(variants)[::-1]):
            calls, turn = variants[name], [0]

            def rotate():
                calls[turn[0] % len(calls)]()
                turn[0] += 1
            event_us = _variants.event_ms(torch, rotate, 64,
                                          warmup=len(calls)) * 1e3
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(64):
                    rotate()
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages() if "wkv_kernel" in e.key]
            device_us = sum(e.device_time_total for e in dev) / 64
            if not dev or device_us <= 0:
                raise SystemExit("the profiler recorded no wkv kernel")
            key = "decode " + name
            times.setdefault(key, []).append(device_us)
            print(json.dumps({"round": rnd, "variant": key,
                              "device_us": device_us, "event_us": event_us}),
                  flush=True)
    print(json.dumps({"medians": {k: statistics.median(v)
                                  for k, v in times.items()},
                      "units": "prefill ms (events), decode device us"}),
          flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
