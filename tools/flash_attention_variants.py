#!/usr/bin/env python3
"""Time the general flash-attention route (csrc/flash_attention.cu, the
tensor-core 3xTF32 kernel), its knobs as edited copies of its source, and
the parent commit's kernel, on one CUDA card in turns.

    python3 tools/flash_attention_variants.py [--parent DIR] [--rounds N]

DIR is the `src` directory of the parent commit (default
build/parent/src: unpack it there first, e.g.
`git archive HEAD^ src | tar -x -C build/parent`); the parent's C entry
point has the same signature.

Shapes: qwen3-1.7b's prefill (8, 2048, 16/8, 128) fp32 causal, and
(8, 2048, 4/2, 16) causal in fp32 and bf16 (the smoke configs' head dim
at a realistic length). Variants (EDITS): the kernel as it is (`change`);
its plan: a ring of 2 stages, 64-key tiles, 8 warps a CTA (and both); the
designs it was chosen over, as code the edits put back into a copy of the
source (the package keeps only the chosen path): Q's fragments read from
shared memory, fp32 K / V split once per tile in shared memory, p v
summed in the MMA accumulator over every key (`tc_acc`), q k^T's k-steps
summed apart too (`fresh_qk`), the hi·hi product first; how the split is
done: Q's split hoistable out of the tile loop, rounding by
cvt.rna.tf32.f32, Veltkamp's split on the fp32 pipe, lo left for the MMA
to truncate; and, timing only (wrong on purpose, their
lines say so): 1xTF32 (one product each; it fails the 2e-5 (1 + |plain|)
limit), no p v products, no q k^T products. Before the kernels it times
mma.sync TF32 alone (tools/mma_tf32_peak.cu).

Every variant is first run once and held against the plain version
(ref.py): max abs error and whether it is within the limit. The build
line of each variant gives registers and spill bytes of its instances at
the timed shapes (nvcc -Xptxas -v). Rounds time every variant in forward
order, then in reverse order (CUDA events over back-to-back launches of
the C entry point after 2 warm-up launches). One JSON line per timing,
then one line of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import sys

import _variants

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = "repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# name -> (B, S, H, KV, hd, dtype name)
SHAPES = {"qwen3_fp32": (8, 2048, 16, 8, 128, "float32"),
          "hd16_fp32": (8, 2048, 4, 2, 16, "float32"),
          "hd16_bf16": (8, 2048, 4, 2, 16, "bfloat16")}
# the package's kernel keeps only the chosen design; the alternatives
# measured against it are these edits of its source (texts replaced in
# order; each must be found, _variants.write_edits)
Q_REGS = """  float qf[KD][4];
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h2 = e & 1;
      qf[ks][e] = row_ok[h2] ? to_f32(qrow[h2][ks * 8 + tq + 4 * (e >> 1)]) : 0.0f;
    }
"""
Q_SMEM = """  T* Qs = reinterpret_cast<T*>(smem + kStages * P::stage);
  for (int idx = tid; idx < BQ * HD; idx += WARPS * 32) {
    const int rl = idx / HD;
    const int d = idx % HD;
    const int64_t r = r0 + rl;
    T x = from_f32<T>(0.0f);
    if (r < n_rows) x = q[(r / a.rep) * a.q_ss + (g * a.rep + r % a.rep) * a.q_sh + d];
    Qs[rl * RS + d] = x;
  }
"""
BYTES = "  static constexpr int bytes = kStages * stage;"
TILE = """    const T* Ks = ring + (j % kStages) * 2 * kBKV * RS;
    const T* Vs = Ks + kBKV * RS;
"""
# fp32 K and V split once per tile by the whole CTA: hi in place, lo in a
# buffer beside the ring, 4 values a step
TILE_PRESPLIT = """    T* Ks = ring + (j % kStages) * 2 * kBKV * RS;
    const T* Vs = Ks + kBKV * RS;
    uint32_t* Lo = reinterpret_cast<uint32_t*>(smem + kStages * P::stage);
    if constexpr (sizeof(T) == 4) {
#pragma unroll 4
      for (int idx = 4 * tid; idx < 2 * kBKV * RS; idx += 4 * WARPS * 32) {
        const float4 x = *reinterpret_cast<const float4*>(Ks + idx);
        uint4 h, lw;
        split(x.x, h.x, lw.x);
        split(x.y, h.y, lw.y);
        split(x.z, h.z, lw.z);
        split(x.w, h.w, lw.w);
        *reinterpret_cast<uint4*>(Ks + idx) = h;
        *reinterpret_cast<uint4*>(Lo + idx) = lw;
      }
      __syncthreads();
    }
"""
K_FRAG = """        const float kx[2] = {to_f32(Ks[at]), to_f32(Ks[at + 4])};
        split_frag<QK>(kx, bh[nt], bl[nt]);
"""
K_FRAG_PRESPLIT = """        if constexpr (sizeof(T) == 4) {
          bh[nt][0] = reinterpret_cast<const uint32_t*>(Ks)[at];
          bh[nt][1] = reinterpret_cast<const uint32_t*>(Ks)[at + 4];
          bl[nt][0] = Lo[at];
          bl[nt][1] = Lo[at + 4];
        } else {
""" + K_FRAG + "        }\n"
V_FRAG = """          const float vx[2] = {to_f32(Vs[at]), to_f32(Vs[at + RS])};
          split_frag<(PV >= 3 ? 2 : 1)>(vx, bh[i], bl[i]);
"""
V_FRAG_PRESPLIT = """          if constexpr (sizeof(T) == 4) {
            bh[i][0] = reinterpret_cast<const uint32_t*>(Vs)[at];
            bh[i][1] = reinterpret_cast<const uint32_t*>(Vs)[at + RS];
            bl[i][0] = Lo[kBKV * RS + at];
            bl[i][1] = Lo[kBKV * RS + at + RS];
          } else {
""" + V_FRAG + "          }\n"
SMALL_FIRST = """#pragma unroll
  for (int i = 0; i < NC && N >= 2; ++i) mma(d[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NC && N >= 3; ++i) mma(d[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < NC; ++i) mma(d[i], ah, bh[i][0], bh[i][1]);
"""
HI_FIRST = """#pragma unroll
  for (int i = 0; i < NC; ++i) mma(d[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NC && N >= 2; ++i) mma(d[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NC && N >= 3; ++i) mma(d[i], ah, bl[i][0], bl[i][1]);
"""
QK_MMA = "      mma_products<QK, NT>(s, ah, al, bh, bl);\n"
QK_MMA_FRESH = """      {
        float f[NT][4] = {};
        mma_products<QK, NT>(f, ah, al, bh, bl);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += f[nt][e];
      }
"""
EDITS = {  # variant -> [(text, replacement)] in flash_attention.cu
    "change": [],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "bkv64": [("constexpr int kBKV = 32;", "constexpr int kBKV = 64;")],
    "warps8": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "q_smem": [(BYTES, BYTES[:-1] + " + WARPS * 16 * row_bytes;"),
               (Q_REGS, Q_SMEM),
               ("qx[e] = opaque(qf[ks][e]);",
                "qx[e] = to_f32(Qs[(warp * 16 + gq + 8 * (e & 1)) * RS + "
                "ks * 8 + tq + 4 * (e >> 1)]);")],
    "presplit": [(BYTES, BYTES[:-1] + " + (sizeof(T) == 4 ? stage : 0);"),
                 (TILE, TILE_PRESPLIT), (K_FRAG, K_FRAG_PRESPLIT),
                 (V_FRAG, V_FRAG_PRESPLIT)],
    # every product of p v summed in the tensor cores' accumulator; q k^T's
    # k-steps summed apart (fresh) too
    "tc_acc": [("        for (int e = 0; e < 4; ++e) f[i][e] = 0.0f;",
                "        for (int e = 0; e < 4; ++e) f[i][e] = acc[d0 + i][e];"),
               ("acc[d0 + i][e] += f[i][e];", "acc[d0 + i][e] = f[i][e];")],
    "fresh_qk": [(QK_MMA, QK_MMA_FRESH)],
    "hi_first": [(SMALL_FIRST, HI_FIRST)],
    "tf32x1": [("struct Splits<float> { static constexpr int qk = 3, pv = 3; }",
                "struct Splits<float> { static constexpr int qk = 1, pv = 1; }")],
    # Q's split hoistable out of the tile loop (as the compiler then does);
    # every cvt kept in program order
    "q_hoist": [("qx[e] = opaque(qf[ks][e]);", "qx[e] = qf[ks][e];")],
    # rounding by cvt.rna.tf32.f32 (the conversion pipe)
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
             "  return r;")],
    # hi by Veltkamp's split on the fp32 pipe (t = 8193 x, hi = t - (t - x):
    # 11 bits, ties to even) and lo = x - hi as it is (12 bits, truncated)
    "split_fp": [("  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));",
                  "  const float t = x * 8193.0f;\n"
                  "  const float h = __fsub_rn(t, __fsub_rn(t, x));\n"
                  "  hi = __float_as_uint(h);\n"
                  "  lo = __float_as_uint(__fsub_rn(x, h));")],
    "bkv64_warps8": [("constexpr int kBKV = 32;", "constexpr int kBKV = 64;"),
                     ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    # lo = x - hi as it is: the MMA reads its top 19 bits (truncation)
    "lo_trunc": [("lo = tf32(x - __uint_as_float(hi));",
                  "lo = __float_as_uint(x - __uint_as_float(hi));")],
    # timing only, to see where the time goes: no p v products; no q k^T
    # products
    "no_pv": [("        mma_products<PV, DG>(f, ph[kk], pl[kk], bh, bl);\n", "")],
    "no_qk": [(QK_MMA, "")],
}
NOT_KERNELS = ("tf32x1", "no_pv", "no_qk")   # wrong on purpose
LIMIT = 2e-5                       # chip_smoke.py's FLASH_TOL["float32"]


def _ptxas(log: str) -> dict:
    """{instance: "registers/spill bytes"} for the instances at the timed
    head dims (fp32 hd 128, both dtypes at hd 16), CTA-sized plans."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"flash\w*?kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E"
                      r"Lb(\d)E", ln)
        if m:
            name = "{}_hd{}_w{}_al{}".format(
                "fp32" if m.group(1) == "f" else "bf16", *m.group(2, 3, 4))
            spill = 0
            continue
        sp = re.search(r"(\d+) bytes spill stores", ln)
        if sp:
            spill = int(sp.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            if name.split("_")[1] in ("hd128", "hd16"):
                out[name] = f"{m.group(1)}/{spill}"
            name = None
    return out


def _mma_peak(torch, lib) -> None:
    """mma.sync m16n8k8 TF32 alone (tools/mma_tf32_peak.cu): one CTA an SM
    of 4, 8 or 16 warps (1, 2, 4 a scheduler), TFLOP/s by CUDA events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chains, iters = lib.mma_tf32_chains(), 20000
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.mma_tf32_peak
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = {}
    for warps in (4, 8, 16):
        buf = torch.empty(sms * warps * 32, device="cuda")

        def call():
            if fn(buf.data_ptr(), sms, warps, iters, stream):
                raise SystemExit("mma_tf32_peak launch failed")
        ms = _variants.event_ms(torch, call, 5)
        flops = sms * warps * iters * chains * 2 * 16 * 8 * 8
        out[f"{warps} warps/SM"] = flops / ms / 1e9
    print(json.dumps({"mma_sync_tf32_tflops": out, "chains": chains}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build/parent/src"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", help="variants to time (default "
                    "all, and the parent)")
    args = ap.parse_args()
    import torch
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    parent_src = pathlib.Path(args.parent) / SRC
    if not parent_src.exists():
        raise SystemExit(f"{parent_src} not found: unpack the parent first")
    edits = {k: v for k, v in EDITS.items()
             if not args.only or k in args.only}
    out_dir = ROOT / "build" / "variants"
    sources = {"fa_parent": parent_src,
               **_variants.write_edits(ROOT / "src" / SRC, edits, out_dir,
                                       prefix="fa_")}
    sources["mma_tf32_peak"] = ROOT / "tools" / "mma_tf32_peak.cu"
    logs = _build.build_files(sources, out_dir)
    peak = ctypes.CDLL(str(out_dir / "libmma_tf32_peak.so"))
    del sources["mma_tf32_peak"]
    fns = {}
    for name in sources:
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).flash_attention_fwd
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr] * 4 + [i64] * 21 + [ctypes.c_double, i64, ptr]
        fn.restype = ctypes.c_int
        fns[name.removeprefix("fa_")] = fn
        print(json.dumps({"build": name, "ptxas": _ptxas(logs[name])}),
              flush=True)
    _variants.print_card(torch)
    _mma_peak(torch, peak)
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for shape, (B, S, H, KV, hd, dname) in SHAPES.items():
        dtype = getattr(torch, dname)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype)
        out = torch.empty_like(q)
        want = ref.flash_attention_ref(q, k, v).float()
        call_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, S, H, KV, hd, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 0,
                     S, 0, 1, hd ** -0.5, 0 if dname == "float32" else 1,
                     stream)

        def caller(name):
            def call():
                _build.check(fns[name](*call_args), name)
            return call

        names = list(fns)
        for name in names:
            out.zero_()
            caller(name)()
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            limit = LIMIT * (1 + want.abs())
            if dtype == torch.bfloat16:     # plus one bf16 ulp of |plain|
                _, e = torch.frexp(want.abs().clamp(min=2.0 ** -126))
                limit = limit + torch.ldexp(torch.ones_like(want), e - 8)
            print(json.dumps({"shape": shape, "variant": name,
                              "max_abs_err": float(diff.max()),
                              "worst_vs_limit": float((diff / limit).max()),
                              "within_limit": bool((diff <= limit).all()),
                              "timing_only": name in NOT_KERNELS}),
                  flush=True)
        iters = 10 if hd == 128 else 30
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                ms = _variants.event_ms(torch, caller(name), iters)
                key = f"{shape} {name}"
                times.setdefault(key, []).append(ms)
                print(json.dumps({"round": rnd, "variant": key, "ms": ms}),
                      flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()
    print(json.dumps({"medians_ms": {k: statistics.median(v)
                                     for k, v in times.items()}}),
          flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
