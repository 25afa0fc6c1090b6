#!/usr/bin/env python3
"""Time variants of the tensor-core flash prefill kernel on one CUDA card,
to see what bounds it.

    python3 tools/flash_prefill_variants.py

Each variant is the port's csrc/flash_prefill.cu with one text edit,
compiled with the port's nvcc flags into build/variants/ and called
through its C entry point at qwen3-1.7b's prefill shape (B 8, S 2048,
16 / 8 heads, hd 128, bf16, causal):

  base      - the kernel as it is
  no_lo     - P rounded to bf16 alone: one P V product, not hi + lo
  no_overlap - wait for the previous tile's P V before the softmax
  stages2, stages4 - a K / V ring of 2 or 4 tiles, not 3
  no_mask   - the masking of diagonal tiles switched off

Only base is a correct kernel; the max abs error against the plain version
is printed for each. base runs first and last. One JSON line per run, times
from CUDA events over 30 launches after 3 warm-up launches.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_prefill.cu"
EDITS = {  # variant -> (text, replacement)
    "base": None,
    "no_lo": ("    wgmma_pv<HD>(o, p_lo[kk], v_rows);\n", ""),
    "no_overlap": ("    wgmma_wait<1>();  // S is done", "    wgmma_wait<0>();  // S is done"),
    "stages2": ("constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    "stages4": ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
    "no_mask": ("const bool masked = kb", "const bool masked = false && kb"),
}


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, edit in EDITS.items():
        src = text
        if edit is not None:
            if edit[0] not in src:
                raise SystemExit(f"{name}: {edit[0]!r} not in {SRC.name}")
            src = src.replace(edit[0], edit[1])
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int64
        lib.flash_prefill_fwd.argtypes = (
            [p] * 4 + [i] * 5 + [i] * 12 + [i] * 4 + [ctypes.c_double, p])
        lib.flash_prefill_fwd.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "Used" in ln and "registers" in ln])

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, KV, hd = 8, 2048, 16, 8, 128
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    out = torch.empty_like(q)
    want = ref.flash_attention_ref(q, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, KV, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 0, S, 0, 1, hd ** -0.5, stream)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for name in list(EDITS) + ["base"]:
        fn = libs[name][0].flash_prefill_fwd

        def call():
            _build.check(fn(*args), name)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(30):
            call()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({
            "variant": name, "ms": start.elapsed_time(end) / 30,
            "max_abs_err": float((out.float() - want.float()).abs().max()),
            "ptxas": libs[name][1]}), flush=True)


if __name__ == "__main__":
    main()
