#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases NAME [NAME ...]

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
                 Sq, q_offset, rep 1 / 2 / 4), qwen3-1.7b's bf16 prefill
                 and gemma3-27b's local prefill (window 1024) on
                 flash_prefill; decode steps (kv_len 1 .. 2111, rep
                 1 / 2 / 8, a window, 16 rows, fp32 and bf16, one split and
                 many), qwen3-1.7b's decode and gemma3-27b's ring decode
                 (non-causal over 1024 and 300 ring slots) on flash_decode;
                 head dim 12 on the general route (fp32 and bf16, prompts
                 and <= 16-row decode steps, rep 1 / 2 / 4, causal,
                 non-causal, a window, q_offset with a ragged Sq, views off
                 16-byte alignment); the full-width prefill and decode of
                 minicpm-2b (rep 1, hd 64) and qwen2-vl-2b (rep 6, hd 128)
                 on flash_prefill and flash_decode; hymba-1.5b's windowed
                 prefill (window 1024) and its ring decode of 5 rows a kv
                 head, whisper-base's non-causal encoder over 1500 frames
                 (a ragged last query tile) and its cross-attention (4
                 prompt rows and decode rows over the frames) and
                 self-attention decode steps; hymba-smoke's hd-12 window
                 and whisper-smoke's hd-16 non-causal calls (Sq != Skv) on
                 the general route;
  wkv_kernel   - wkv against its plain version: every head dim at S 1, 15,
                 16, 17, 33 and 1024 with and without an initial state, the JAX
                 sweep, state chaining over two calls, the rwkv6-7b prefill
                 shape and one-token decode steps chained from its final
                 state; it reports which cases were bit-equal;
  collectives  - psum, ring_allreduce and optcc_allreduce at p=4 against
                 x.sum(0), and the straggler's link count (Lemma 5);
  main_path    - `repro_torch.launch.train.main` on qwen3-1.7b at full width
                 through healthy -> degraded -> repaired steps, saving the
                 full train state (~17.2 GB) as checkpoint step_4 in a
                 directory under `build/` (removed at the end);
  resume       - the same launcher again: it restores step_4 (every leaf
                 bit-equal to what was saved: hashes taken on the card) and
                 runs steps 4-5, which must equal the main path's;
  elastic      - again, with a node loss at step 4: it restores step_4,
                 saves it again (the overwrite path), halves the DP members
                 to 2, restores and runs steps 4-5 (chunk_reduce at W = 2);
                 step 4's loss equals the main path's, and steps 4-5 equal
                 to the bit a 2-member run resumed from step_4;
  schedules    - the flow model: the simulator on the host (CPU named in
                 the line) over single-straggler profiles at p 16, 64 and
                 256, two stragglers and a multi-GPU server, "auto" and
                 every supported algorithm at n = 2^20, k = 16 (makespan
                 over T0 and over the lower bound, plan-generation ms,
                 simulation seconds, the slot descriptor's ms at p = 1024);
                 then the schedule executor on the card over each
                 supported algorithm's Flow-object schedule of four
                 profiles, fp32 and bf16: at n = 2^25 + 1 every rank's
                 output held to an fp64 sum within (p - 1) u sum|x_i|, at
                 n = 2^20 + 1 to the CPU executor bit for bit; and
                 qwen3-1.7b's full gradient (the main path's parameter
                 count, 1,720,574,976 bf16 elements) at p = 4 with straggler 0 at l = 1.5, through the ring
                 the runtime's FaultState plans and through OptCC. No
                 kernel is on this path (three JSON lines);
  sweeps       - the fault-scenario sweeps on the host: `python -m
                 repro_torch.sweeps --smoke --telemetry --deterministic`
                 with 0 and 8 worker processes, the two artifacts
                 byte-equal and hashing to the JAX package's artifact
                 (SWEEP_SHA256), `check` against ci/sweep_thresholds.json;
                 then one measured run: generation p99 and the re-planning
                 latency at p = 1024 beside the thresholds' 1 ms limit
                 (reported, not gated);
  dryrun       - `repro_torch.launch.dryrun.run_cell` on qwen3-1.7b's
                 cells and both production meshes (seconds a cell); then
                 qwen3-1.7b's GSPMD step at GSPMD_REMAT's 6 x 1024 with
                 remat none and full, run on the card under
                 torch.utils.flop_counter and traced on `meta`: the two
                 FLOP counts equal, and the trace's peak live bytes
                 within a factor of 2 of the card's max_memory_allocated.
                 No kernel is launched on this path;
  dist_collectives - the process transport: four processes on the card
                 over gloo, hops staged through pinned host memory. psum
                 (bf16) and optcc_allreduce_tree (fp32, straggler 1) at the
                 main path's gradient length, each held on every rank to
                 the sum recomputed from per-rank seeds (psum to the bit),
                 the straggler's link at 2 x the padded length; then every
                 collective (psum, ring, OptCC flat and tree at stragglers
                 0 / 1 / 3, psum_tree, hierarchical 2 x 2, compressed with
                 its residual) at 2^24 + 1 elements on both transports,
                 bit-equal (digests of the bits taken on the card); per
                 collective the wall seconds, each hop's staging, gloo-wait
                 and combine (chunk_reduce, CUDA events) times, bytes per
                 link and launches;
  main_path_dist - `launch.train --transport gloo` on qwen3-1.7b at full
                 width and 8 of 28 layers, 4 ranks on the card, healthy ->
                 degraded -> repaired, and the same run over the
                 single-process transport: the final parameters' hashes
                 (taken on the card) equal;
  serve_qwen3  - `repro_torch.launch.serve.main` on qwen3-1.7b at full width
                 and depth (batch 8, prompt 2048, 64 new tokens);
  serve_rwkv6  - the same on rwkv6-7b (batch 4, prompt 1024, 32 new tokens);
  main_path_internlm2, main_path_hymba - the training launcher on
                 internlm2-1.8b (untied lm_head) and hymba-1.5b (bf16
                 leaves beside fp32 ones: the healthy sync launches the
                 W-way form once per dtype) at full width through healthy
                 -> degraded -> repaired steps, no checkpoint;
  serve_gemma3 - the same on gemma3-27b (62 layers, 52 local with a window
                 of 1024 and a rolling cache, 10 global; batch 4, prompt
                 2048, 32 new tokens): each layer kind's attention calls
                 counted beside the launches;
  serve_internlm2, serve_minicpm, serve_qwen2vl - the same on
                 internlm2-1.8b, minicpm-2b and qwen2-vl-2b at full width
                 and depth (batch 8, prompt 2048, 64 new tokens);
  serve_hymba  - the same on hymba-1.5b (32 layers; batch 8, prompt 2048,
                 past its window of 1024, 64 new tokens), with the Mamba
                 branch's share of the prefill and the decode timed;
  serve_whisper - the same on whisper-base (6 + 6 layers; batch 16, 1500
                 frames, a 4-token prompt, 224 new tokens);
  main_path_phi35moe - the training launcher on phi3.5-moe at full width
                 and one layer (`--set n_layers=1`; bf16 experts beside
                 the fp32 router: two gradient buffers), as internlm2's;
  train_gspmd_minicpm - `make_gspmd_train_step` (the single-device GSPMD
                 step) on minicpm-2b at full width and depth, remat
                 "full", 4 microbatches of 2 x 4096 tokens, 3 steps: each
                 step's seconds, loss, grad norm, peak GiB and mfu; first,
                 at 2 layers, such a step against one with remat "none";
  train_gspmd_remat - the same step on qwen3-1.7b at full width and depth
                 with remat none, full and dots at the largest (batch,
                 sequence) at which "none" fits the card (peak GiB and
                 seconds of each), then 16 x 4096 tokens as 8
                 microbatches with "full";
  serve_phi35moe, serve_arctic - the serve launcher on phi3.5-moe (24 of
                 32 layers) and arctic-480b (2 of 35) at full width,
                 depth cut by `--set n_layers=N` to fit the card (batch 8,
                 prompt 2048, 64 new tokens), with the share of the
                 prefill's token-expert slots dropped at capacity;
  reference    - the DP step on the qwen3, gemma3, internlm2, minicpm,
                 qwen2-vl, hymba, phi3.5-moe, arctic and rwkv6 smoke
                 configs, card against CPU, and the loss and gradients of
                 qwen2-vl with a patch-embedding prefix and of whisper
                 with its frames;
  serve_reference - the ten smoke configs: the card's greedy tokens
                 equal the CPU's (the fp32 smoke prefills are the general
                 flash_attention route's path, and at head dim 12,
                 minicpm, qwen2-vl and hymba, so are their decode steps;
                 each hd-12 call is held to the plain version), and
                 prefill/decode logits equal `forward`'s (gemma3's and
                 hymba's decode past their rings' wrap; the MoE configs
                 at capacity factor 8, where nothing drops);
  timing       - each kernel at its path's shapes (CUDA events, host
                 included, and `device_ms`: the kernels' own time from
                 torch.profiler) beside its bound, its plain version and one
                 PyTorch library call that computes the same function, where
                 there is one (chunk_reduce also at W = 2, the elastic run's
                 shape, and both its forms also at internlm2-1.8b's
                 gradient length; flash_prefill also at gemma3-27b's local
                 prefill and at minicpm-2b's and qwen2-vl-2b's prefills,
                 flash_decode at gemma3-27b's ring decode and those two
                 models' decode steps, the general route at head dim 12,
                 and the new shapes of hymba-1.5b and whisper-base; the
                 W-way form at hymba's and phi3.5-moe's two gradient
                 buffers and the pair form at their lengths; flash_prefill
                 and flash_decode at phi3.5-moe's and arctic-480b's
                 prefill and decode, 4 and 7 query heads a kv head);
                 wkv's decode step also with its inputs cold in L2,
                 rotating over 16 sets of inputs and states.

Each path (training, its resumed and rescaled runs, the process
transport's collectives and training, internlm2's, hymba's and
phi3.5-moe's training, the GSPMD steps, the ten serve runs, the smoke
configs' card run) is
driven with the kernels' launch counts set to 0 just before it and read
just after. Then it prints the whole run's seconds, the card's name and
power limit (nvidia-smi), a `kernels` JSON line, and, as the last line,
{"ok": true, "device": {...}}. Any failed check raises: the script exits
nonzero and prints no result. It needs a CUDA card and the rest of the
repository; it imports nothing of JAX.

`--phases` runs only the named phases of those that stand alone (see
`ALONE`), in the order given, after building the kernels unless no named
phase launches one; a phase that needs the main path's gradient length
takes it from qwen3-1.7b's config. It prints their JSON lines, each one's seconds
and the card's name and power limit, but no `kernels` line and no `ok`
line: it is a quick look at a few paths, not the smoke test.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
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
# the prompt is longer than the local window, so the rings wrap in prefill
SERVE_GEMMA3 = {"arch": "gemma3-27b", "batch": 4, "prompt_len": 2048,
                "new_tokens": 32}
# the remaining dense decoders: internlm2 (untied head), minicpm (MHA, hd
# 64), qwen2-vl (M-RoPE over text positions, 6 query heads a kv head)
SERVE_INTERNLM2 = {"arch": "internlm2-1.8b", "batch": 8, "prompt_len": 2048,
                   "new_tokens": 64}
SERVE_MINICPM = {"arch": "minicpm-2b", "batch": 8, "prompt_len": 2048,
                 "new_tokens": 64}
SERVE_QWEN2VL = {"arch": "qwen2-vl-2b", "batch": 8, "prompt_len": 2048,
                 "new_tokens": 64}
# hymba-1.5b: the prompt is longer than its window of 1024, so the rings
# wrap in prefill; whisper-base: 30 s of audio (1500 frames), a 4-token
# start prompt and whisper's default sample_len of n_text_ctx // 2 = 224
SERVE_HYMBA = {"arch": "hymba-1.5b", "batch": 8, "prompt_len": 2048,
               "new_tokens": 64}
SERVE_WHISPER = {"arch": "whisper-base", "batch": 16, "prompt_len": 4,
                 "new_tokens": 224}
# the MoE decoders at full width with depth cut (`--set n_layers=N`): all
# 32 layers of phi3.5-moe are 83.7 GB of bf16 weights, one layer of
# arctic-480b 27.2 GB; 24 layers (62.9 GB) and 2 (55.4 GB) fit one card
SERVE_PHI35MOE = {"arch": "phi3.5-moe-42b-a6.6b", "batch": 8,
                  "prompt_len": 2048, "new_tokens": 64,
                  "set": ["n_layers=24"], "phase": "serve_phi35moe"}
SERVE_ARCTIC = {"arch": "arctic-480b", "batch": 8, "prompt_len": 2048,
                "new_tokens": 64, "set": ["n_layers=2"],
                "phase": "serve_arctic"}
SERVE_SPECS = (SERVE_QWEN3, SERVE_RWKV6, SERVE_GEMMA3, SERVE_INTERNLM2,
               SERVE_MINICPM, SERVE_QWEN2VL, SERVE_HYMBA, SERVE_WHISPER,
               SERVE_PHI35MOE, SERVE_ARCTIC)
# the smoke configs whose DP step phase_reference runs card against CPU
DENSE_ARCHS = ("qwen3-1.7b", "gemma3-27b", "internlm2-1.8b", "minicpm-2b",
               "qwen2-vl-2b")
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "arctic-480b")
REFERENCE_ARCHS = DENSE_ARCHS + ("hymba-1.5b",) + MOE_ARCHS + ("rwkv6-7b",)
# the smoke configs whose serving phase_serve_reference runs card and CPU
SERVE_REFERENCE_ARCHS = DENSE_ARCHS + ("rwkv6-7b", "hymba-1.5b",
                                       "whisper-base") + MOE_ARCHS
FLASH_ROUTES = ("flash_attention", "flash_prefill", "flash_decode")
# the timing fields of each kernel in the `kernels` line
LINE_FIELDS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--dp", "4", "--seq-len", "128",
             "--global-batch", "8", "--steps", "6", "--fail-at", "2",
             "--repair-at", "4", "--straggler", "1", "--log-every", "1"]
CKPT_STEP = 4              # the main path saves once, after step 3
# internlm2-1.8b's and hymba-1.5b's training: healthy step 0, degraded
# 1-2, repaired 3
INTERNLM2_ARGV = ["--arch", "internlm2-1.8b", "--dp", "4", "--seq-len",
                  "128", "--global-batch", "8", "--steps", "4", "--fail-at",
                  "1", "--repair-at", "3", "--straggler", "1",
                  "--log-every", "1"]
HYMBA_ARGV = ["--arch", "hymba-1.5b"] + INTERNLM2_ARGV[2:]
# phi3.5-moe at full width, one layer (1,562,914,816 bf16 parameters and
# its 65,536 fp32 router): at two layers the DP-4 train state does not fit
PHI35MOE_ARGV = ["--arch", "phi3.5-moe-42b-a6.6b", "--set",
                 "n_layers=1"] + INTERNLM2_ARGV[2:]
# the process transport (one gloo process per member on the one card):
# phase_dist_collectives runs every collective on both transports at
# DIST_N, and psum / the OptCC tree at the main path's gradient length;
# phase_main_path_dist trains qwen3-1.7b at full width, DIST_LAYERS of its
# 28 layers (four train states on one card), over both transports
DIST_P, DIST_N, DIST_SEED = 4, 2 ** 24 + 1, 5
DIST_LAYERS = 8
DIST_ARGV = ["--arch", "qwen3-1.7b", "--set", f"n_layers={DIST_LAYERS}"] + \
    INTERNLM2_ARGV[2:]
# the DP step's card-vs-CPU limits (phase_reference): loss rel, params abs.
# AdamW divides by sqrt(nu) per element, so a float-order difference in a
# near-zero gradient grows into an update difference of up to lr.
STEP_TOL = (1e-5, 1e-4)
REFERENCE_LR, REFERENCE_STEPS = 1e-3, 3      # phase_reference's DP run
HASH_SLICE = 1 << 26       # elements per slice of a leaf's card hash
# the single-device GSPMD step (make_gspmd_train_step). minicpm-2b at full
# width and depth: train_4k's sequence of 4096, its global batch of 256
# cut to 8 (4 microbatches of 2) to fit the script's time, remat="full"
# as the JAX dry run sets it on train cells; the remat-vs-none check at
# `check_layers` layers, where a step without remat fits the card
GSPMD_MINICPM = {"arch": "minicpm-2b", "seq_len": 4096, "global_batch": 8,
                 "microbatches": 4, "steps": 3, "remat": "full",
                 "check_layers": 2, "lr": 1e-3}
# qwen3-1.7b: remat none / full / dots at the largest (batch, seq_len) at
# which "none" fits the card with 20 GiB to spare (tools/gspmd_phases.py
# --probe: "none" peaks at 45.0 GiB at 4 x 1024 and 71.6 of 79.2 at
# 8 x 1024; 2 x 2048 and 1 x 4096 run out), two steps each (the first
# also grows the allocator's pool, so only the second is warm), then
# `long`
GSPMD_REMAT = {"arch": "qwen3-1.7b", "batch": 6, "seq_len": 1024,
               "steps": 2, "lr": 1e-3,
               "long": {"seq_len": 4096, "global_batch": 16,
                        "microbatches": 8, "remat": "full"}}
GSPMD_SEED = 0
# the flow model (phase_schedules). Host part: the simulator on the
# machine's CPU at SCHEDULE_HOST's profiles, n = 2^20, k = 16, for "auto"
# and every supported algorithm (columnar schedules where a twin exists,
# Flow objects only up to SCHEDULE_FLOW_P ranks), and the O(p k) slot
# descriptor of each profile's pattern at SCHEDULE_DESC_P ranks. Card part:
# the executor on the card over each supported algorithm's Flow-object
# schedule of SCHEDULE_CARD's profiles, fp32 and bf16 at SCHEDULE_FULL_N
# (held element-wise to an fp64 sum within (p - 1) u sum|x_i|) and at
# SCHEDULE_SMALL_N (held to the CPU executor to the bit); then qwen3-1.7b's
# full gradient at p = 4, straggler 0, l = 1.5, in bf16
SCHEDULE_SEED = 7
SCHEDULE_N, SCHEDULE_K = 1 << 20, 16
SCHEDULE_HOST = tuple(("single", p, ell, 0) for p in (16, 64, 256)
                      for ell in (1.25, 1.5, 2.0)) + (
    ("multi", 16, (2.0, 1.5)), ("gpu", 16, 4, 2.0))
SCHEDULE_FLOW_P, SCHEDULE_DESC_P = 16, 1024
SCHEDULE_CARD = (("single", 8, 2.0, 0), ("multi", 16, (2.0, 1.5)),
                 ("gpu", 16, 4, 2.0), ("healthy", 16))
SCHEDULE_FULL_N, SCHEDULE_SMALL_N = 2 ** 25 + 1, 2 ** 20 + 1
SCHEDULE_SLICE = 1 << 26     # elements per slice of the fp64 check
UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}
# the fault-scenario sweeps (phase_sweeps): the sha256 of the JAX package's
# `python -m repro.sweeps --smoke --telemetry --deterministic` artifact
# (seed 0), which tests/test_torch_sweeps.py pins too; the CI thresholds
SWEEP_SHA256 = \
    "b071e366dd80c2d29a9420cf72d0afca1081fa53deea6ada8641c4643b25049d"
SWEEP_ARGS = ["--smoke", "--telemetry"]
SWEEP_WORKERS = (0, 8)
SWEEP_THRESHOLDS = "ci/sweep_thresholds.json"
# the dry run (phase_dryrun): qwen3-1.7b's cells on both meshes, and its
# GSPMD step at GSPMD_REMAT's shape counted on `meta` against the card;
# the trace's peak live bytes over max_memory_allocated must lie in
# DRYRUN_PEAK_RATIO
DRYRUN_ARCH = "qwen3-1.7b"
DRYRUN_REMATS = ("none", "full")
DRYRUN_PEAK_RATIO = (0.5, 2.0)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _param_count(arch: str) -> int:
    """A config's parameter count, from its init on fake tensors."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.sharding import eval_shape
    model = build_model(get_config(arch))
    return model.param_count(eval_shape(model.init, 0, device="cpu"))


# phases that run alone under --phases: name -> fn(torch, dev)
ALONE = {
    "collectives": lambda torch, dev: phase_collectives(torch, dev),
    "schedules": lambda torch, dev: phase_schedules(
        torch, dev, _param_count("qwen3-1.7b")),
    "dist_collectives": lambda torch, dev: phase_dist_collectives(
        torch, dev, _param_count("qwen3-1.7b")),
    "main_path_dist": lambda torch, dev: phase_main_path_dist(torch, dev),
    "train_gspmd_minicpm": lambda torch, dev: phase_train_gspmd_minicpm(
        torch, dev),
    "train_gspmd_remat": lambda torch, dev: phase_train_gspmd_remat(
        torch, dev),
    "sweeps": lambda torch, dev: phase_sweeps(),
    "dryrun": lambda torch, dev: phase_dryrun(torch, dev),
}
KERNEL_FREE = ("schedules", "train_gspmd_minicpm", "train_gspmd_remat",
               "sweeps", "dryrun")


def run_alone(torch, dev, names: list) -> int:
    if any(name not in KERNEL_FREE for name in names):
        from repro_torch import _build
        t = time.perf_counter()
        _build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t})
    for name in names:
        t = time.perf_counter()
        ALONE[name](torch, dev)
        emit({"phase": name + "_alone", "seconds": time.perf_counter() - t})
    print(_smi(), flush=True)
    return 0


def main() -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="+", choices=sorted(ALONE),
                    metavar="NAME", help="run only these phases: "
                    + ", ".join(ALONE))
    args = ap.parse_args()
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
    if args.phases:
        return run_alone(torch, dev, args.phases)

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
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_", dir=_build.BUILD_DIR.parent)
    try:
        n_grad, launches, main_run = phase_main_path(torch, dev, ckpt_dir)
        phase_resume(torch, dev, ckpt_dir, main_run)
        phase_elastic(torch, dev, ckpt_dir, main_run)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del main_run
    phase_schedules(torch, dev, n_grad)
    phase_sweeps()
    phase_dryrun(torch, dev)
    _add(launches, phase_dist_collectives(torch, dev, n_grad))
    _add(launches, phase_main_path_dist(torch, dev))
    n_internlm2, internlm2_launches = phase_main_path_arch(
        torch, dev, INTERNLM2_ARGV)
    _add(launches, internlm2_launches)
    n_hymba, hymba_launches = phase_main_path_arch(torch, dev, HYMBA_ARGV)
    _add(launches, hymba_launches)
    n_phi35moe, phi35moe_launches = phase_main_path_arch(torch, dev,
                                                         PHI35MOE_ARGV)
    _add(launches, phi35moe_launches)
    _add(launches, phase_train_gspmd_minicpm(torch, dev))
    _add(launches, phase_train_gspmd_remat(torch, dev))
    for spec in SERVE_SPECS:
        _add(launches, phase_serve(torch, dev, spec))
    phase_reference(torch, dev)
    _add(launches, phase_serve_reference(torch, dev))
    timings = phase_timing(torch, dev, n_grad, n_internlm2, n_hymba,
                           n_phi35moe, errs)
    timings.update(phase_serve_timing(torch, dev, errs))
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})

    print(_smi(), flush=True)
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


def _add(total: dict, counts: dict) -> None:
    """Add a path's kernel launches to the run's totals."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


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


def _attn_shape(spec: dict):
    """(B, S, H, KV, hd) of a serve run's attention."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    return (spec["batch"], spec["prompt_len"], cfg.n_heads, cfg.n_kv_heads,
            cfg.hd)


def _serve_cfg(spec: dict):
    from repro_torch.configs import get_config
    return get_config(spec["arch"])


def _gemma3_attn_shape():
    """(B, S, H, KV, hd, local window) of the serve_gemma3 run."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_GEMMA3["arch"])
    return (SERVE_GEMMA3["batch"], SERVE_GEMMA3["prompt_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cfg.local_window)


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
    B, S, H, KV, hd = _attn_shape(SERVE_QWEN3)
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
    # gemma3-27b's local layers (hd 128, GQA 32/16, bf16): one prompt of the
    # serve run's length within the window, and a decode row over a full
    # ring and a part-filled one (non-causal over its first kv_len slots)
    Bg, S, H, KV, hd, w = _gemma3_attn_shape()
    q = rand((1, S, H, hd), bf)
    k, v = rand((1, S, KV, hd), bf), rand((1, S, KV, hd), bf)
    check(q, k, v, f"gemma3 local prefill window {w}", "flash_prefill",
          tight=True, window=w)
    del q, k, v
    ring_k, ring_v = (rand((Bg, w, KV, hd), bf) for _ in range(2))
    q = rand((Bg, 1, H, hd), bf)
    for kv_len in (w, 300):
        check(q, ring_k, ring_v, f"gemma3 ring decode kv_len {kv_len}",
              "flash_decode", tight=True, causal=False, kv_len=kv_len)
    cases += 3
    del q, ring_k, ring_v
    torch.cuda.empty_cache()
    # head dim 12 (the minicpm and qwen2-vl smoke configs) on the general
    # route, its MMA width padded to 16: fp32 and bf16; prompts of 4-warp
    # CTAs and <= 16-row decode steps of one warp; rep 1 / 2 / 4; causal,
    # non-causal, a window; a ragged chunk after a cached prefix; views
    # off 16-byte alignment. flash_decode has no hd-12 template, so an
    # aligned fp32 decode step is the general route's too.
    for dtype in (torch.float32, torch.bfloat16):
        for rep in (1, 2, 4):
            q = rand((2, 150, 2 * rep, 12), dtype)
            k, v = rand((2, 150, 2, 12), dtype), rand((2, 150, 2, 12), dtype)
            for kw in ({}, {"window": 24}, {"causal": False}):
                check(q, k, v, f"hd 12 {dtype} rep {rep} {kw}",
                      "flash_attention", tight=True, **kw)
            kc, vc = rand((2, 300, 2, 12), dtype), rand((2, 300, 2, 12), dtype)
            check(q[:, :77], kc, vc, f"hd 12 {dtype} rep {rep} q_offset 200",
                  "flash_attention", tight=True, q_offset=200, kv_len=277)
            check(q[:, :1], kc, vc, f"hd 12 {dtype} rep {rep} decode",
                  "flash_attention", tight=True, q_offset=289, kv_len=290)
            check(q[:, :16 // rep], kc, vc,
                  f"hd 12 {dtype} rep {rep} 16 rows window 5",
                  "flash_attention", tight=True, q_offset=270,
                  kv_len=270 + 16 // rep, window=5)
            cases += 6
        n = 2 * 300 * 2 * 12
        store = rand((n + 3,), dtype)
        k, v = store[1:1 + n].view(2, 300, 2, 12), \
            store[3:3 + n].view(2, 300, 2, 12)
        check(rand((2, 150, 4, 12), dtype), k, v,
              f"hd 12 {dtype} unaligned prompt", "flash_attention",
              tight=True)
        check(rand((2, 1, 4, 12), dtype), k, v,
              f"hd 12 {dtype} unaligned decode", "flash_attention",
              tight=True, q_offset=290, kv_len=291)
        cases += 2
    # the full-width prefill and decode steps of minicpm-2b (36/36 heads,
    # hd 64: rep 1) and qwen2-vl-2b (12/2, hd 128: rep 6, so a decode step
    # has 6 rows a kv head), bf16 as served, at the fp32 limit plus one
    # bf16 rounding; the decode steps over the prompt's cache at its first
    # and last positions and the serve run's first, middle and last steps
    for spec in (SERVE_MINICPM, SERVE_QWEN2VL):
        B, S, H, KV, hd = _attn_shape(spec)
        q = rand((B, S, H, hd), bf)
        k, v = rand((B, S, KV, hd), bf), rand((B, S, KV, hd), bf)
        check(q, k, v, f"{spec['arch']} prefill", "flash_prefill",
              tight=True)
        del q, k, v
        n_new = spec["new_tokens"]
        kc, vc = (rand((B, S + n_new, KV, hd), bf) for _ in range(2))
        q = rand((B, 1, H, hd), bf)
        for pos in (0, S - 1, S, S + n_new // 2, S + n_new - 2):
            check(q, kc, vc, f"{spec['arch']} decode pos={pos}",
                  "flash_decode", tight=True, q_offset=pos, kv_len=pos + 1)
            splits.add(kernel.decode_splits(pos + 1, B * KV, sms))
        cases += 6
        del kc, vc, q
        torch.cuda.empty_cache()
    # hymba-1.5b (25/5 heads, hd 64, window 1024): one batch row of the
    # serve run's windowed prefill; decode rows of 5 queries a kv head over
    # a full ring and a part-filled one, non-causal over the filled slots
    cfg = _serve_cfg(SERVE_HYMBA)
    Bh, S, w = SERVE_HYMBA["batch"], SERVE_HYMBA["prompt_len"], \
        cfg.hymba_window
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rand((1, S, H, hd), bf)
    k, v = rand((1, S, KV, hd), bf), rand((1, S, KV, hd), bf)
    check(q, k, v, f"hymba prefill window {w}", "flash_prefill", tight=True,
          window=w)
    del q, k, v
    ring_k, ring_v = (rand((Bh, w, KV, hd), bf) for _ in range(2))
    q = rand((Bh, 1, H, hd), bf)
    for kv_len in (w, 1, 300):
        check(q, ring_k, ring_v, f"hymba ring decode kv_len {kv_len}",
              "flash_decode", tight=True, causal=False, kv_len=kv_len)
    cases += 4
    del q, ring_k, ring_v
    # whisper-base (8/8 heads, hd 64, 1500 frames): the encoder's
    # non-causal prefill over the frames (1500 is no multiple of the
    # 64-query tile) for two rows of the serve batch; the cross-attention of
    # the 4-token prompt (4 rows a kv head) and of a decode step over all
    # the frames; the decoder's self-attention at its first and last decode
    # steps
    cfg = _serve_cfg(SERVE_WHISPER)
    Bw, F = SERVE_WHISPER["batch"], cfg.n_audio_frames
    P, n_new = SERVE_WHISPER["prompt_len"], SERVE_WHISPER["new_tokens"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rand((2, F, H, hd), bf)
    k, v = rand((2, F, KV, hd), bf), rand((2, F, KV, hd), bf)
    check(q, k, v, "whisper encoder", "flash_prefill", tight=True,
          causal=False)
    del q, k, v
    xk, xv = (rand((Bw, F, KV, hd), bf) for _ in range(2))
    for Sq in (P, 1):
        check(rand((Bw, Sq, H, hd), bf), xk, xv,
              f"whisper cross-attention Sq {Sq}", "flash_decode",
              tight=True, causal=False)
    kc, vc = (rand((Bw, P + n_new, KV, hd), bf) for _ in range(2))
    q = rand((Bw, 1, H, hd), bf)
    for pos in (P, P + n_new - 2):
        check(q, kc, vc, f"whisper self decode pos={pos}", "flash_decode",
              tight=True, q_offset=pos, kv_len=pos + 1)
    cases += 5
    del q, xk, xv, kc, vc
    torch.cuda.empty_cache()
    # the smoke configs' shapes on the general route: hymba-smoke's hd 12
    # within its window of 16 (a prompt that wraps it) and whisper-smoke's
    # hd 16 encoder and a non-causal prompt of 40 queries over 24 frames
    # (Sq != Skv), in fp32
    f32 = torch.float32
    q = rand((2, 40, 5, 12), f32)
    k, v = rand((2, 40, 5, 12), f32), rand((2, 40, 5, 12), f32)
    check(q, k, v, "hymba-smoke prompt window 16", "flash_attention",
          tight=True, window=16)
    k, v = rand((2, 24, 4, 16), f32), rand((2, 24, 4, 16), f32)
    check(rand((2, 24, 4, 16), f32), k, v, "whisper-smoke encoder",
          "flash_attention", tight=True, causal=False)
    check(rand((2, 40, 4, 16), f32), k, v, "whisper-smoke Sq 40 over 24",
          "flash_attention", tight=True, causal=False)
    cases += 3
    del q, k, v
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


def _schedule_profile(BP, spec: tuple):
    """A SCHEDULE_* spec as a BandwidthProfile."""
    kind, p, *args = spec
    if kind == "healthy":
        return BP.healthy(p)
    if kind == "single":
        ell, straggler = args
        return BP.single_straggler(p, ell, straggler)
    if kind == "multi":
        return BP.multi_straggler(p, list(args[0]))
    g, ell = args                  # server 0 degraded
    return BP.single_straggler(p, ell, 0, g=g)


def _host_cpu() -> dict:
    """The host CPU as /proc/cpuinfo names it (its model name, which a
    virtual machine may report as "unknown", with the vendor, family and
    model numbers), its architecture and core count."""
    import platform
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, value = ln.partition(":")
            key = key.strip().lower()
            if not key:
                break                       # the first processor's block
            info.setdefault(key, value.strip())
    name = " ".join(filter(None, (
        info.get("model name") or platform.processor(), info.get("vendor_id"),
        "family " + info["cpu family"] if "cpu family" in info else "",
        "model " + info["model"] if "model" in info else "")))
    return {"name": name or "not reported", "machine": platform.machine(),
            "cores": os.cpu_count()}


def _schedules_host() -> list:
    """The simulator on the host: per profile and algorithm the plan's
    generation ms, the simulation's seconds, makespan / T0 and makespan /
    lower bound (which must be >= 1), and the descriptor's ms at
    SCHEDULE_DESC_P ranks (the best of 5 calls, and the first)."""
    from repro_torch.core import make_plan, registry, simulate
    from repro_torch.core.model import BandwidthProfile
    from repro_torch.core.planner import plan_descriptor
    n, k = SCHEDULE_N, SCHEDULE_K
    out = []
    for spec in SCHEDULE_HOST:
        prof = _schedule_profile(BandwidthProfile, spec)
        wide = _schedule_profile(BandwidthProfile,
                                 (spec[0], SCHEDULE_DESC_P) + spec[2:])
        desc_ms = []
        for _ in range(5):
            t = time.perf_counter()
            plan_descriptor(wide, n, k)
            desc_ms.append((time.perf_counter() - t) * 1e3)
        rows = []
        for name in ("auto",) + registry.supported(prof):
            arrays = name == "auto" or \
                registry.get(name).generate_arrays is not None
            if not arrays and prof.p > SCHEDULE_FLOW_P:
                rows.append({"algo": name, "skipped": "Flow objects only "
                             f"up to p = {SCHEDULE_FLOW_P}"})
                continue
            t = time.perf_counter()
            plan = make_plan(prof, n, k, materialize="arrays" if arrays
                             else True, algo=name)
            gen_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            res = simulate(plan.schedule)
            sim_s = time.perf_counter() - t
            require(res.makespan >= plan.lower_bound * (1 - 1e-12),
                    f"{spec} {name}: makespan {res.makespan} below the "
                    f"lower bound {plan.lower_bound}")
            rows.append({"algo": name, "plan": plan.algo,
                         "columnar": arrays,
                         "flows": plan.schedule.num_flows, "gen_ms": gen_ms,
                         "sim_s": sim_s,
                         "makespan_over_t0": res.makespan / plan.t0,
                         "makespan_over_lb": res.makespan / plan.lower_bound,
                         "predicted_over_t0": plan.predicted_overhead})
        out.append({"profile": spec, "p": prof.p,
                    "descriptor_ms": {"p": SCHEDULE_DESC_P,
                                      "best": min(desc_ms),
                                      "first": desc_ms[0]},
                    "algos": rows})
    return out


def _worst_over_bound(torch, x, out, what: str) -> float:
    """Every rank's output against the fp64 sum of the inputs, in slices of
    SCHEDULE_SLICE elements: |out - sum| <= (p - 1) u sum|x_i| element-wise
    (u the dtype's unit roundoff; NaN fails). Returns the largest
    |out - sum| / bound."""
    p, n = x.shape
    u = UNIT_ROUNDOFF[str(x.dtype).removeprefix("torch.")]
    worst = 0.0
    for lo in range(0, n, SCHEDULE_SLICE):
        xs = x[:, lo:lo + SCHEDULE_SLICE].double()
        want = xs.sum(0)
        bound = (p - 1) * u * xs.abs().sum(0)
        del xs
        for r in range(p):
            err = (out[r, lo:lo + SCHEDULE_SLICE].double() - want).abs()
            ok = err <= bound
            require(bool(ok.all()), f"{what}: rank {r} off the fp64 sum past "
                    f"(p - 1) u sum|x_i| at {int((~ok).sum())} elements "
                    f"from {lo}")
            ratio = torch.where(bound > 0, err / bound, torch.zeros_like(err))
            worst = max(worst, float(ratio.max()))
    return worst


def _card_execute(torch, sched, x) -> tuple:
    """The executor on the card: its output, CUDA-event seconds of a second
    run (the first, untimed, grows the allocator's pool) and peak GiB."""
    from repro_torch.core.executor import execute
    execute(sched, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = execute(sched, x)
    end.record()
    torch.cuda.synchronize()
    return (out, start.elapsed_time(end) / 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _schedules_card(torch, dev) -> list:
    """Each supported algorithm's Flow-object schedule of SCHEDULE_CARD's
    profiles on the card: at SCHEDULE_FULL_N held to the fp64 sum, at
    SCHEDULE_SMALL_N to the CPU executor, bit for bit."""
    from repro_torch.core import make_plan, registry
    from repro_torch.core.executor import execute
    from repro_torch.core.model import BandwidthProfile
    gen = torch.Generator(device=dev).manual_seed(SCHEDULE_SEED)
    rows = []
    for spec in SCHEDULE_CARD:
        prof = _schedule_profile(BandwidthProfile, spec)
        for name in registry.supported(prof):
            full = make_plan(prof, SCHEDULE_FULL_N, algo=name).schedule
            small = make_plan(prof, SCHEDULE_SMALL_N, algo=name).schedule
            for dtype in (torch.float32, torch.bfloat16):
                what = f"{spec} {name} {dtype}"
                x = torch.randn((prof.p, SCHEDULE_FULL_N), generator=gen,
                                device=dev).to(dtype)
                out, seconds, peak = _card_execute(torch, full, x)
                worst = _worst_over_bound(torch, x, out, what)
                del x, out
                x = torch.randn((prof.p, SCHEDULE_SMALL_N), generator=gen,
                                device=dev).to(dtype)
                card, small_s, _ = _card_execute(torch, small, x)
                require(torch.equal(card.cpu(), execute(small, x.cpu())),
                        f"{what}: the card's executor differs from the "
                        f"CPU's at n = {SCHEDULE_SMALL_N}")
                del x, card
                rows.append({"profile": spec, "algo": name,
                             "plan": full.meta["algo"],
                             "dtype": str(dtype).removeprefix("torch."),
                             "flows": full.num_flows, "n": SCHEDULE_FULL_N,
                             "seconds": seconds, "peak_gib": peak,
                             "max_err_over_bound": worst,
                             "small_n": SCHEDULE_SMALL_N,
                             "small_seconds": small_s,
                             "small_bit_equal_to_cpu": True})
            torch.cuda.empty_cache()
    return rows


def _schedules_qwen3(torch, dev, n: int) -> list:
    """qwen3-1.7b's full gradient of n elements synced in bf16 at p = 4
    with straggler 0 at l = 1.5: the plan the runtime's FaultState returns
    and OptCC."""
    from repro_torch.comms.fault import FaultState
    from repro_torch.core import make_plan
    state = FaultState(4, 0, 1.5)
    gen = torch.Generator(device=dev).manual_seed(SCHEDULE_SEED + 1)
    x = torch.empty((4, n), dtype=torch.bfloat16, device=dev)
    for row in x:
        row.normal_(generator=gen)
    rows = []
    for source, plan in (
            ("FaultState.plan", state.plan(n, materialize=True)),
            ("make_plan(algo='optcc')",
             make_plan(state.profile(), n, materialize=True, algo="optcc"))):
        what = f"qwen3-1.7b {source} {plan.algo}"
        out, seconds, peak = _card_execute(torch, plan.schedule, x)
        worst = _worst_over_bound(torch, x, out, what)
        del out
        torch.cuda.empty_cache()
        rows.append({"source": source, "plan": plan.algo, "n": n,
                     "dtype": "bfloat16", "flows": plan.schedule.num_flows,
                     "seconds": seconds, "peak_gib": peak,
                     "max_err_over_bound": worst})
    del x
    torch.cuda.empty_cache()
    return rows


def phase_schedules(torch, dev, n_grad: int) -> None:
    """The flow model: the simulator on the host and the schedule executor
    on the card (SCHEDULE_* above; qwen3-1.7b's gradient of n_grad
    elements). No kernel of the port is on this path: the executor's adds
    are torch ops, and the launch counts stay 0."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t = time.perf_counter()
    emit({"phase": "schedules_host", "cpu": _host_cpu(),
          "n": SCHEDULE_N, "k": SCHEDULE_K, "profiles": _schedules_host(),
          "seconds": time.perf_counter() - t})
    torch.cuda.empty_cache()
    reset_launch_counts()
    t = time.perf_counter()
    rows = _schedules_card(torch, dev)
    emit({"phase": "schedules_card", "device": torch.cuda.get_device_name(0),
          "seed": SCHEDULE_SEED, "schedules": rows,
          "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    rows = _schedules_qwen3(torch, dev, n_grad)
    launches = launch_counts()
    require(not any(launches.values()),
            f"the executor launched kernels of the port: {launches}")
    emit({"phase": "schedules_qwen3", "arch": "qwen3-1.7b", "p": 4,
          "straggler": 0, "ell": 1.5, "runs": rows,
          "seconds": time.perf_counter() - t})


def _sweep(args: list, cwd: str) -> tuple:
    """`python -m repro_torch.sweeps ARGS` in its own process (its workers
    fork from a process that never touched the card): (seconds, its
    output)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.sweeps",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=600)
    seconds = time.perf_counter() - t
    require(proc.returncode == 0, f"sweeps {args}: exit {proc.returncode}\n"
            + proc.stdout[-2000:] + proc.stderr[-2000:])
    return seconds, proc.stdout


def phase_sweeps() -> None:
    """The fault-scenario sweeps on the host (numpy; no card work): the
    deterministic smoke artifact with telemetry from SWEEP_WORKERS worker
    processes, byte-equal and hashing to the JAX package's (SWEEP_SHA256),
    checked against SWEEP_THRESHOLDS; then a measured run's generation p99
    and re-planning latency at p = 1024 beside the thresholds' limit."""
    import hashlib
    t_phase = time.perf_counter()
    thresholds = str(ROOT / SWEEP_THRESHOLDS)
    with open(thresholds) as f:
        limit_ms = json.load(f)["schedgen_latency_ms_max"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        blobs = []
        for workers in SWEEP_WORKERS:
            out = os.path.join(tmp, f"w{workers}.json")
            seconds, _ = _sweep(SWEEP_ARGS + ["--deterministic", "--workers",
                                              str(workers), "--out", out],
                                tmp)
            with open(out, "rb") as f:
                blobs.append(f.read())
            runs[f"workers_{workers}"] = {"seconds": seconds}
        require(all(b == blobs[0] for b in blobs),
                f"sweep artifacts differ across workers {SWEEP_WORKERS}")
        digest = hashlib.sha256(blobs[0]).hexdigest()
        require(digest == SWEEP_SHA256,
                f"sweep artifact sha256 {digest} is not the JAX package's "
                f"{SWEEP_SHA256}")
        seconds, checked = _sweep(["check", os.path.join(tmp, "w0.json"),
                                   "--thresholds", thresholds], tmp)
        runs["check"] = {"seconds": seconds,
                         "output": checked.strip().splitlines()}
        out = os.path.join(tmp, "measured.json")
        seconds, _ = _sweep(SWEEP_ARGS + ["--workers",
                                          str(max(SWEEP_WORKERS)), "--out",
                                          out], tmp)
        with open(out) as f:
            measured = json.load(f)
    overall = measured["summary"]["overall"]
    latency = measured["schedgen_latency_ms"]
    emit({"phase": "sweeps", "cpu": _host_cpu(),
          "scenarios": measured["scenario_count"],
          "schema": measured["schema"], "sha256": digest,
          "sha256_is_jax": True, "deterministic": runs,
          "measured": {"seconds": seconds, "workers": max(SWEEP_WORKERS),
                       "gen_ms_p50": overall["gen_ms_p50"],
                       "gen_ms_p99": overall["gen_ms_p99"],
                       "schedgen_latency_ms_p1024": latency,
                       "limit_ms": limit_ms,
                       "within_limit": latency <= limit_ms,
                       "overhead_optcc_p99": overall["overhead_optcc_p99"]},
          "seconds": time.perf_counter() - t_phase})


def _dryrun_cells() -> tuple:
    """`run_cell` on DRYRUN_ARCH's cells, both meshes, into a temporary
    directory: (one summary a cell, `roofline.report`'s tables of the
    records, by mesh)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for mesh in ("single", "multi"):
            for shape in SHAPES:
                t = time.perf_counter()
                rec = dryrun.run_cell(DRYRUN_ARCH, shape, mesh, force=True,
                                      out_dir=tmp)
                row = {"shape": shape.name, "mesh": mesh,
                       "status": rec["status"],
                       "seconds": time.perf_counter() - t}
                require(rec["status"] in ("ok", "skipped"),
                        f"dry run {shape.name} {mesh}: {rec.get('error')}")
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    row.update({
                        "trace_s": rec["timings"]["trace_s"],
                        "trace_reused": rec["timings"]["trace_reused"],
                        "flops": rec["op_count"]["flops"],
                        "hbm_bytes": rec["op_count"]["hbm_bytes"],
                        "peak_live_bytes":
                            rec["memory_analysis"]["peak_live_bytes"],
                        "model_flops": r["model_flops"],
                        "t_compute_s": r["t_compute_s"],
                        "t_memory_s": r["t_memory_s"],
                        "dominant": r["dominant"],
                        "useful_flops_fraction": r["useful_flops_fraction"],
                        "info": rec["info"]})
                rows.append(row)
        tables = {mesh: {"roofline": report.table(mesh, out_dir=tmp)
                         .splitlines(),
                         "memory": report.memory_table(mesh, out_dir=tmp)
                         .splitlines()} for mesh in ("single", "multi")}
    return rows, tables


def _dryrun_step(torch, dev, remat: str, batch: dict) -> dict:
    """qwen3-1.7b's GSPMD step (one microbatch) on the card under
    torch.utils.flop_counter, and the same step traced on `meta`
    (roofline.op_count): both FLOP counts, the card's peak allocated bytes
    and the trace's peak live bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.schedules import constant
    from repro_torch.roofline.op_count import analyze_program, meta_like
    from repro_torch.sharding import Mesh
    from repro_torch.train import (TrainState, init_train_state,
                                   make_gspmd_train_step)
    cfg = get_config(DRYRUN_ARCH).replace(remat=remat)
    model = build_model(cfg)
    step = make_gspmd_train_step(model, Mesh((1,), ("data",)), AdamWConfig(),
                                 constant(GSPMD_REMAT["lr"]))
    t = time.perf_counter()
    params = meta_params(cfg)
    count, _ = analyze_program(
        step, TrainState(params, init_state(params, AdamWConfig()), 0),
        meta_like(batch))
    trace_s = time.perf_counter() - t
    state = init_train_state(model, AdamWConfig(), GSPMD_SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    t = time.perf_counter()
    with counter:
        state, m = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    require(math.isfinite(float(m["loss"])), f"remat={remat}: loss "
            f"{float(m['loss'])}")
    del state
    torch.cuda.empty_cache()
    card_flops = counter.get_total_flops()
    ratio = count.peak_live_bytes / peak
    row = {"remat": remat, "meta_flops": count.flops,
           "flop_counter_flops": card_flops,
           "flops_equal": count.flops == card_flops,
           "peak_live_gib": count.peak_live_bytes / 2 ** 30,
           "max_allocated_gib": peak / 2 ** 30, "peak_ratio": ratio,
           "hbm_bytes": count.hbm_bytes, "trace_s": trace_s,
           "step_seconds": seconds}
    require(row["flops_equal"], f"remat={remat}: meta FLOPs {count.flops} "
            f"!= the card's flop counter's {card_flops}")
    require(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
            f"remat={remat}: peak live {count.peak_live_bytes} over max "
            f"allocated {peak} = {ratio}")
    return row


def phase_dryrun(torch, dev) -> None:
    """The dry run: DRYRUN_ARCH's cells (`_dryrun_cells`), then its step
    at GSPMD_REMAT's shape with each of DRYRUN_REMATS, counted on `meta`
    and run on the card (`_dryrun_step`). The launch counts are set to 0
    before and must stay 0: the training step has no kernel, and on
    `meta` a kernel only records its work."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    t = time.perf_counter()
    cells, tables = _dryrun_cells()
    cells_seconds = time.perf_counter() - t
    cfg = get_config(DRYRUN_ARCH)
    batch = _gspmd_batches(torch, dev, cfg, GSPMD_REMAT["batch"],
                           GSPMD_REMAT["seq_len"], 1, GSPMD_SEED)[0]
    steps = [_dryrun_step(torch, dev, remat, batch)
             for remat in DRYRUN_REMATS]
    launches = launch_counts()
    require(not any(launches.values()),
            f"the dry run launched kernels of the port: {launches}")
    emit({"phase": "dryrun", "arch": DRYRUN_ARCH, "cells": cells,
          "cells_seconds": cells_seconds, "report": tables,
          "step": {"batch": GSPMD_REMAT["batch"],
                   "seq_len": GSPMD_REMAT["seq_len"], "runs": steps},
          "seconds": time.perf_counter() - t_phase})


def _hop_lines(hops: list) -> list:
    """A rank's hops as [kind, staging s, gloo-wait s, combine ms, bytes
    out, bytes in]."""
    return [[h["kind"], h["stage_s"], h["wait_s"], h["combine_ms"],
             h["bytes_out"], h["bytes_in"]] for h in hops]


def _links(ranks: list, key: str = "bytes") -> list:
    """The link counts of a run over ranks: each link as its sender
    counted it (its receiver counts the same)."""
    p = len(ranks)
    return [[int(ranks[s][key][s, d]) for d in range(p)] for s in range(p)]


def phase_dist_collectives(torch, dev, n_grad: int) -> dict:
    """The process transport on the card (four ranks on cuda:0, gloo, hops
    staged through pinned host buffers); returns the ranks' chunk_reduce
    launches. First psum (bf16) and optcc_allreduce_tree (fp32, straggler
    1) at n_grad elements, each result held on every rank against the sum
    recomputed from the ranks' seeds, segment by segment: psum to the bit,
    the tree within COLLECTIVE_TOL; the straggler's link carries the padded
    vector out and back once. Then every collective at DIST_N on both
    transports, equal to the bit (digests of the bits, taken on the
    card)."""
    from repro_torch.comms import LocalTransport, dist, parity
    p = DIST_P
    torch.cuda.empty_cache()
    launches = {}
    t = time.perf_counter()
    ranks = dist.spawn(parity.full_length, p,
                       (p, n_grad, DIST_SEED, str(dev), 32 << 20, 1))
    seconds = time.perf_counter() - t
    npad = n_grad + (-n_grad) % (p - 1)
    line = {"phase": "dist_collectives", "p": p, "n": n_grad,
            "spawn_seconds": seconds,
            "peak_gib": [r.get("peak_gib") for r in ranks]}
    for name in ("psum", "tree"):
        per = [r[name] for r in ranks]
        for r in per:
            _add(launches, r["launches"])
        line[name] = {
            "seconds": [r["seconds"] for r in per],
            "max_abs_err": max(r["max_abs_err"] for r in per),
            "bytes_per_link": _links(per),
            "launches": [r["launches"] for r in per],
            "hops": [_hop_lines(r["hops"]) for r in per]}
    tree = ranks[1]["tree"]["elems"]
    require(tree[1].sum() == npad and tree[:, 1].sum() == npad,
            f"straggler 1 sent {tree[1].sum()} and received "
            f"{tree[:, 1].sum()} elements, not {npad} each")
    require(line["psum"]["max_abs_err"] == 0.0, "psum not bit-equal")
    line["straggler_link"] = "2 x padded length"
    emit(line)
    del ranks, line

    local = parity.run_suite(LocalTransport(p),
                             parity.inputs(p, DIST_N, DIST_SEED), dev,
                             digest=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dist.spawn(parity.rank_suite, p,
                       (p, DIST_N, DIST_SEED, str(dev), 32 << 20, True))
    seconds = time.perf_counter() - t
    per_collective = {}
    for name, want in local.items():
        got = [r[name] for r in ranks]
        for rank in range(p):
            require(got[rank]["out"][0] == want["out"][rank],
                    f"{name}: rank {rank} differs from the single-process "
                    "transport")
            for key in ("elems", "bytes"):
                mine = got[rank][key]
                require(all(mine[s, d] == (want[key][s, d] if rank in (s, d)
                                           else 0)
                            for s in range(p) for d in range(p)),
                        f"{name}: rank {rank}'s link {key} differ")
        for r in got:
            _add(launches, r["launches"])
        per_collective[name] = {
            "seconds": max(r["seconds"] for r in got),
            "local_seconds": want["seconds"],
            "bytes_per_link": _links(got),
            "launches": _summed(r["launches"] for r in got),
            "stage_s": max(sum(h["stage_s"] for h in r["hops"])
                           for r in got),
            "wait_s": max(sum(h["wait_s"] for h in r["hops"]) for r in got),
            "combine_ms": max(sum(h["combine_ms"] for h in r["hops"])
                              for r in got),
            "hops": max(len(r["hops"]) for r in got)}
    npad = DIST_N + (-DIST_N) % (p - 1)
    for s in (0, 1, 3):
        for kind in ("optcc", "tree"):
            elems = ranks[s][f"{kind}_{s}"]["elems"]
            require(elems[s].sum() == npad and elems[:, s].sum() == npad,
                    f"{kind} straggler {s}: link not 2 x {npad}")
    emit({"phase": "dist_collectives_parity", "p": p, "n": DIST_N,
          "spawn_seconds": seconds, "bit_equal": True,
          "straggler_link": "2 x padded length",
          "collectives": per_collective})
    return launches


def _summed(counts) -> dict:
    total = {}
    for c in counts:
        _add(total, c)
    return total


def phase_main_path_dist(torch, dev) -> dict:
    """`launch.train --transport gloo` (four ranks on the card) and the same
    run over the single-process transport: qwen3-1.7b at full width and
    DIST_LAYERS layers, healthy -> degraded -> repaired over 4 steps. The
    syncs read psum, optcc, optcc, psum in both; the final parameters'
    hashes, taken on the card, are equal. Returns the ranks' chunk_reduce
    launches."""
    from repro_torch.launch.train import main as train_main
    torch.cuda.empty_cache()
    argv = DIST_ARGV + ["--transport", "gloo"]
    t = time.perf_counter()
    state, log = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    gloo_hashes = _card_hashes(torch, state.params)
    n_params = sum(v.numel() for v in state.params.values())
    del state
    torch.cuda.empty_cache()
    local_state, local_log, local_launches, local_seconds = _run_train(
        torch, DIST_ARGV, [])
    local_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    local_hashes = _card_hashes(torch, local_state.params)
    del local_state
    torch.cuda.empty_cache()
    for run in (log, local_log):
        require([r["sync"] for r in run] == ["psum", "optcc", "optcc",
                                             "psum"],
                f"syncs {[r['sync'] for r in run]}")
        for r in run:
            require(math.isfinite(r["loss"]), f"loss {r['loss']}")
    require([r["loss"] for r in log] == [r["loss"] for r in local_log],
            "the gloo run's losses differ from the local run's")
    require(gloo_hashes == local_hashes, "the gloo run's final parameters "
            "differ from the local run's")
    launches = _summed(r["launches"] for r in log)
    require(launches.get("chunk_reduce", 0) > 0
            and launches.get("chunk_reduce_pairs", 0) > 0,
            f"the ranks launched {launches}")
    keys = ("step", "loss", "sync", "step_seconds", "grad_seconds",
            "sync_seconds", "update_seconds", "launches")
    emit({"phase": "main_path_dist", "argv": argv, "params": n_params,
          "seconds": seconds, "launches": launches,
          "peak_gib_per_rank": log[0]["peak_gib"],
          "params_bit_equal_to_local": True,
          "steps": [{k: r[k] for k in keys} for r in log],
          "local": {"seconds": local_seconds, "launches": local_launches,
                    "peak_gib": local_peak,
                    "steps": [{k: r[k] for k in keys} for r in local_log]},
          "host": _host_memory()})
    return launches


def _close(torch, got, x) -> float:
    """Max |got - x.sum(0)| over every member's row; raises past
    COLLECTIVE_TOL * sum|x_i| (+ the same absolute floor)."""
    diff = (got - x.sum(0)).abs()
    bad = diff > COLLECTIVE_TOL * (1.0 + x.abs().sum(0))
    err = float(diff.max())
    require(not bool(bad.any()), f"collective off by up to {err}")
    return err


def _host_memory() -> dict:
    """The machine's RAM and this process's peak resident set, in GiB."""
    info = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            key, value = ln.split(":")
            info[key] = int(value.split()[0]) * 1024 / 2 ** 30
    return {"ram_gib": info["MemTotal"], "available_gib": info["MemAvailable"],
            "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF)
            .ru_maxrss / 2 ** 20}


def _card_hashes(torch, state) -> dict:
    """{checkpoint key: hash} of a train state, computed on the card: two
    integer sums over each leaf's bits taken as int16 words, one plain and
    one weighted by position (mod 251); an int leaf is its own hash."""
    from repro_torch.checkpoint.ckpt import leaves
    out = {}
    for key, leaf in leaves(state):
        if isinstance(leaf, int):
            out[key] = leaf
            continue
        words = leaf.detach().contiguous().reshape(-1).view(torch.int16)
        plain = weighted = 0
        for start in range(0, words.numel(), HASH_SLICE):
            w = words[start:start + HASH_SLICE].long()
            pos = torch.arange(start, start + w.numel(), device=w.device)
            plain += int(w.sum())
            weighted += int((w * (pos % 251 + 1)).sum())
        out[key] = (plain, weighted)
    return out


@contextlib.contextmanager
def _hashing(torch, seen: list):
    """While it is open, every state the launcher saves is hashed on the
    card before the save and every state it restores after the restore;
    appends (op, step, hashes, hash seconds) to `seen`."""
    from repro_torch.launch import train as launcher
    saved, restored = launcher._saved, launcher._restored

    def timed_hashes(state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        return _card_hashes(torch, state), time.perf_counter() - t

    def saved_hook(ckpt_dir, step, state, device):
        seen.append(("save", step, *timed_hashes(state)))
        return saved(ckpt_dir, step, state, device)

    def restored_hook(*args, **kw):
        out = restored(*args, **kw)
        seen.append(("restore", out[1], *timed_hashes(out[0])))
        return out

    launcher._saved, launcher._restored = saved_hook, restored_hook
    try:
        yield
    finally:
        launcher._saved, launcher._restored = saved, restored


def _io(ev: dict) -> dict:
    return {"seconds": ev["seconds"], "bytes": ev["bytes"],
            "gb_per_s": ev["bytes"] / ev["seconds"] / 1e9}


def _run_train(torch, argv, seen: list):
    """The launcher once, its states hashed; returns (state, log, kernel
    launches in the run, seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    with _hashing(torch, seen):
        state, log = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launch_counts()
    launches = {k: counts[k] for k in ("chunk_reduce", "chunk_reduce_pairs")}
    for rec in log:
        require(math.isfinite(rec["loss"]), f"step {rec['step']}: loss "
                f"{rec['loss']}")
        require(math.isfinite(rec["grad_norm"]), f"step {rec['step']}: "
                f"grad norm {rec['grad_norm']}")
    return state, log, launches, seconds


def _gap(torch, state, log, ref: dict, steps) -> dict:
    """A run's losses at `steps` and final params against those of `ref`
    (a log and a host copy of the params): loss rel, params max abs, the
    count of params past the abs limit, whether both are within STEP_TOL
    and whether all are bit-equal."""
    ref_log = {r["step"]: r for r in ref["log"]}
    loss_rel = max(abs(r["loss"] - ref_log[r["step"]]["loss"])
                   / abs(ref_log[r["step"]]["loss"]) for r in log
                   if r["step"] in steps)
    params_abs, past = 0.0, 0
    equal = loss_rel == 0.0
    for k, v in state.params.items():
        want = ref["params"][k].to(v.device)
        equal = equal and torch.equal(v, want)
        for g, w in zip(v.detach().reshape(-1).split(HASH_SLICE),
                        want.reshape(-1).split(HASH_SLICE)):
            diff = (g.float() - w.float()).abs()
            params_abs = max(params_abs, float(diff.max()))
            past += int((diff > STEP_TOL[1]).sum())
    return {"bit_equal": bool(equal), "loss_rel": loss_rel,
            "params_abs": params_abs, "params_past_abs_limit": past,
            "within_limits": loss_rel < STEP_TOL[0]
            and params_abs < STEP_TOL[1]}


def _host_run(state, log) -> dict:
    return {"log": log, "params": {k: v.detach().cpu() for k, v in
                                   state.params.items()}}


def phase_main_path(torch, dev, ckpt_dir: str):
    """The main path, saving step_4 into `ckpt_dir`; returns the param
    count, the kernels' launches and what the later runs are held to: the
    log, a host copy of the final params and the saved state's hashes."""
    argv = MAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--ckpt-every",
                        str(CKPT_STEP)]
    seen = []
    state, log, launches, seconds = _run_train(torch, argv, seen)
    n_grad = sum(v.numel() for v in state.params.values())
    depth = state.params["blocks/wq"].shape[0]
    for rec in log:
        emit({"phase": "main_step", **rec})
    healthy = [r for r in log if r["sync"] == "psum"]
    degraded = [r for r in log if r["sync"] == "optcc"]
    require(healthy and degraded, "the run did not see both sync kinds")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in healthy),
            "a healthy step did not launch chunk_reduce")
    require(all(r["launches"]["chunk_reduce_pairs"] > 0 for r in degraded),
            "a degraded step did not launch chunk_reduce_pairs")
    events = [ev for r in log for ev in r["checkpoint"]]
    require([(ev["op"], ev["step"]) for ev in events] == [("save", CKPT_STEP)]
            and log[CKPT_STEP - 1]["checkpoint"] == events,
            f"checkpoint work {events}, not one save of step {CKPT_STEP}")
    require([(op, step) for op, step, *_ in seen] == [("save", CKPT_STEP)],
            f"hashed {[x[:2] for x in seen]}")
    free = shutil.disk_usage(ckpt_dir).free
    emit({"phase": "main_path", "argv": argv, "n_layers": depth,
          "params": n_grad, "seconds": seconds, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "save": _io(events[0]), "ckpt_dir": ckpt_dir,
          "ckpt_dir_free_bytes_after_save": free,
          "host": _host_memory()})
    main_run = {**_host_run(state, log), "hashes": seen[0][2]}
    del state
    torch.cuda.empty_cache()
    return n_grad, launches, main_run


def phase_resume(torch, dev, ckpt_dir: str, main_run: dict) -> None:
    """The launcher restarted on the main path's checkpoint: it restores
    step_4 (each leaf bit-equal to the state that was saved) and runs steps
    4-5 on 4 members, which must equal the main path's steps 4-5: to the
    bit, or, where the card's arithmetic is not deterministic, within the
    DP step's card-vs-CPU limits."""
    argv = MAIN_ARGV + ["--ckpt-dir", ckpt_dir]
    seen = []
    state, log, launches, seconds = _run_train(torch, argv, seen)
    require([r["step"] for r in log] == [4, 5], f"resumed steps "
            f"{[r['step'] for r in log]}")
    require(all(r["dp"] == 4 and r["sync"] == "psum" for r in log),
            "the resumed steps are not healthy on 4 members")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in log),
            "a resumed step did not launch chunk_reduce")
    events = log[0]["checkpoint"]
    require([(ev["op"], ev["step"]) for ev in events]
            == [("restore", CKPT_STEP)] and not log[1]["checkpoint"],
            f"checkpoint work {events}")
    require([(op, step) for op, step, *_ in seen]
            == [("restore", CKPT_STEP)], f"hashed {[x[:2] for x in seen]}")
    require(seen[0][2] == main_run["hashes"],
            "a restored leaf differs from the saved one")
    gap = _gap(torch, state, log, main_run, (4, 5))
    require(gap["bit_equal"] or gap["within_limits"],
            f"resumed run vs main path: {gap}")
    emit({"phase": "resume", "argv": argv, "seconds": seconds,
          "restore": _io(events[0]), "restored_bit_equal": True,
          "hash_seconds": seen[0][3], "continuation": gap,
          "limits_if_not_bit_equal": STEP_TOL,
          "losses": [r["loss"] for r in log], "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "host": _host_memory()})
    del state
    torch.cuda.empty_cache()


def phase_elastic(torch, dev, ckpt_dir: str, main_run: dict) -> None:
    """The launcher restarted with a node loss at step 4: it restores
    step_4, saves it again over itself, halves the DP members to 2,
    restores, and runs steps 4-5 on 2 members (the healthy sync's
    chunk_reduce at W = 2). Every state saved or restored is bit-equal to
    the main path's step_4, and step 4's loss (the same parameters and
    batch, averaged over 2 members instead of 4) equals the main path's
    within the DP step's loss limit. Then the launcher resumes step_4 on 2
    members from the start: its steps 4-5 must equal the rescaled run's to
    the bit.

    The final params are not held to the main path's at STEP_TOL: each
    member's gradient is a bf16 sum over 4 rows here and 2 rows there, so
    the two runs' gradients differ by bf16 roundings, their AdamW updates
    by more than a float-order difference, and the bf16 params round
    apart. Their gap is reported."""
    argv = MAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--lose-node-at",
                        str(CKPT_STEP)]
    seen = []
    state, log, launches, seconds = _run_train(torch, argv, seen)
    require([r["step"] for r in log] == [4, 5], f"rescaled steps "
            f"{[r['step'] for r in log]}")
    require(all(r["dp"] == 2 and r["sync"] == "psum" for r in log),
            "the rescaled steps are not healthy on 2 members")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in log),
            "a rescaled step did not launch chunk_reduce")
    events = log[0]["checkpoint"]
    require([(ev["op"], ev["step"]) for ev in events]
            == [("restore", 4), ("save", 4), ("restore", 4), ("rescale", 4)]
            and not log[1]["checkpoint"], f"checkpoint work {events}")
    require([(op, step) for op, step, *_ in seen]
            == [("restore", 4), ("save", 4), ("restore", 4)],
            f"hashed {[x[:2] for x in seen]}")
    require(all(h == main_run["hashes"] for _, _, h, _ in seen),
            "a state saved or restored differs from the main path's step_4")
    require(sorted(os.listdir(ckpt_dir)) == ["step_4"],
            f"checkpoint directory holds {os.listdir(ckpt_dir)}")
    vs_main = _gap(torch, state, log, main_run, (4,))
    require(vs_main["loss_rel"] < STEP_TOL[0], f"step 4 loss off by rel "
            f"{vs_main['loss_rel']}")
    rescaled = _host_run(state, log)
    del state
    torch.cuda.empty_cache()

    argv2 = MAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--dp", "2"]
    seen2 = []
    state, log2, launches2, seconds2 = _run_train(torch, argv2, seen2)
    require([(r["step"], r["dp"]) for r in log2] == [(4, 2), (5, 2)],
            f"2-member resume ran {[(r['step'], r['dp']) for r in log2]}")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in log2),
            "a 2-member step did not launch chunk_reduce")
    require([(op, step) for op, step, *_ in seen2] == [("restore", 4)]
            and seen2[0][2] == main_run["hashes"],
            "the 2-member resume restored another state")
    vs_direct = _gap(torch, state, log2, rescaled, (4, 5))
    require(vs_direct["bit_equal"], "the rescaled run differs from a "
            f"2-member run resumed from the same checkpoint: {vs_direct}")
    rescale = events[3]
    # the launcher's rescale seconds include the hashes of its save and
    # restore, which this script adds
    rescale_s = rescale["seconds"] - seen[1][3] - seen[2][3]
    emit({"phase": "elastic", "argv": argv, "seconds": seconds,
          "restore": _io(events[0]), "save": _io(events[1]),
          "rescale_restore": _io(events[2]), "rescale_seconds": rescale_s,
          "hash_seconds": [x[3] for x in seen], "dp": rescale["dp"],
          "all_states_bit_equal": True, "vs_main_path": vs_main,
          "limits": STEP_TOL, "losses": [r["loss"] for r in log],
          "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "two_member_resume": {
              "argv": argv2, "seconds": seconds2,
              "restore": _io(log2[0]["checkpoint"][0]),
              "launches": launches2, "bit_equal_to_rescaled": True},
          "host": _host_memory()})
    del state, rescaled
    torch.cuda.empty_cache()


def phase_main_path_arch(torch, dev, argv) -> tuple:
    """The training launcher on `argv`'s arch at full width, 4 members,
    healthy step 0, degraded steps 1-2 (OptCC around straggler 1),
    repaired step 3; no checkpoint: internlm2-1.8b (24 layers, an untied
    2048 x 92544 lm_head synced with the rest), hymba-1.5b (32 layers
    of attention and Mamba heads; bf16 leaves beside its fp32 m_dt_bias,
    m_alog and m_d, so the healthy sync packs one buffer per dtype, two
    W-way launches a step besides the loss's, and the degraded one a
    single fp32 buffer) and phi3.5-moe at one layer (`--set n_layers=1`:
    16 experts of 4096 x 6400 in bf16 beside the fp32 router, so two
    buffers too).
    Returns the gradient element count of each dtype and the chunk_reduce
    launches."""
    state, log, launches, seconds = _run_train(torch, argv, [])
    arch = argv[argv.index("--arch") + 1]
    require([r["sync"] for r in log] == ["psum", "optcc", "optcc", "psum"],
            f"{arch} syncs {[r['sync'] for r in log]}")
    groups = {}
    for v in state.params.values():
        key = str(v.dtype).removeprefix("torch.")
        groups[key] = groups.get(key, 0) + v.numel()
    for r in log:
        # a healthy step: one launch per gradient dtype, one for the loss
        if r["sync"] == "psum":
            require(r["launches"]["chunk_reduce"] == len(groups) + 1,
                    f"a healthy {arch} step launched chunk_reduce "
                    f"{r['launches']['chunk_reduce']} times, not once per "
                    f"dtype of {sorted(groups)} and once for the loss")
        else:
            require(r["launches"]["chunk_reduce_pairs"] > 0,
                    f"a degraded {arch} step did not launch "
                    "chunk_reduce_pairs")
    require("lm_head" in state.params, f"{arch} has no untied lm_head")
    name = "phi35moe" if arch.startswith("phi3.5-moe") else \
        arch.split("-")[0]
    emit({"phase": "main_path_" + name, "argv": argv,
          "n_layers": state.params["blocks/wq"].shape[0],
          "params": sum(groups.values()), "params_by_dtype": groups,
          "seconds": seconds, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "steps": [{k: r[k] for k in ("step", "loss", "grad_norm", "sync",
                                       "algo", "step_seconds",
                                       "grad_seconds", "sync_seconds",
                                       "update_seconds", "launches")}
                    for r in log],
          "host": _host_memory()})
    del state
    torch.cuda.empty_cache()
    return groups, launches


def _gspmd_batches(torch, dev, cfg, batch: int, seq_len: int, steps: int,
                   seed: int) -> list:
    """`steps` SyntheticLM batches of (batch, seq_len) tokens on the card,
    made before any step is timed."""
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len, global_batch=batch,
                                  seed=seed))
    return [{k: torch.from_numpy(v).long().to(dev)
             for k, v in data.batch(i).items()} for i in range(steps)]


def _gspmd_steps(torch, dev, cfg, batches: list, nmb: int, lr: float,
                 seed: int = GSPMD_SEED):
    """`make_gspmd_train_step` on cfg from `init_train_state(seed)`, one
    step a batch; returns (state, one record a step: seconds, the step's
    own grad / update seconds, loss, grad norm, its peak GiB, tokens and
    mfu = 6 params tokens / (seconds x the bf16 peak))."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.sharding import Mesh
    from repro_torch.train import init_train_state, make_gspmd_train_step
    model = build_model(cfg)
    state = init_train_state(model, AdamWConfig(), seed, dev)
    n_params = sum(v.numel() for v in state.params.values())
    step = make_gspmd_train_step(model, Mesh((1,), ("data",)), AdamWConfig(),
                                 constant(lr), num_microbatches=nmb)
    records = []
    for batch in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        tokens = batch["tokens"].numel()
        rec = {"step": state.step - 1, "seconds": seconds,
               "grad_seconds": m["grad_seconds"],
               "update_seconds": m["update_seconds"],
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "tokens": tokens,
               "mfu": 6 * n_params * tokens / (seconds * BF16_FLOPS)}
        require(math.isfinite(rec["loss"]) and
                math.isfinite(rec["grad_norm"]),
                f"{cfg.name} step {rec['step']}: loss {rec['loss']}, grad "
                f"norm {rec['grad_norm']}")
        records.append(rec)
    return state, records


def _params_finite(torch, state, what: str) -> None:
    for k, v in state.params.items():
        require(all(bool(torch.isfinite(s).all())
                    for s in v.detach().reshape(-1).split(HASH_SLICE)),
                f"{what}: non-finite {k}")


def _sign_flip_gap(torch, got: dict, want: dict, lr: float,
                   steps: int = 1) -> dict:
    """Parameters after `steps` AdamW steps against others from the same
    init: each within AdamW's sign-flip bound, 2 lr a step (plus one bf16
    rounding of the parameter). Returns the largest gap and the count
    past 1e-4."""
    worst, past, n = 0.0, 0, 0
    for k, w in want.items():
        for g, r in zip(got[k].detach().reshape(-1).split(HASH_SLICE),
                        w.reshape(-1).split(HASH_SLICE)):
            g, r = g.float(), r.to(g.device).float()
            diff = (g - r).abs()
            limit = 2 * lr * steps + (_ulp_bf16(torch, r)
                                      if w.dtype == torch.bfloat16 else 0.0)
            require(not bool((diff > limit).any()),
                    f"{k}: {float(diff.max())} past AdamW's sign-flip bound")
            worst = max(worst, float(diff.max()))
            past += int((diff > STEP_TOL[1]).sum())
            n += diff.numel()
    return {"params_abs": worst, "params_past_1e-4": past, "params": n}


def phase_train_gspmd_minicpm(torch, dev) -> dict:
    """minicpm-2b at full width and depth through `make_gspmd_train_step`
    on one card, remat="full", microbatches of 2 rows of 4096 tokens:
    first, at GSPMD_MINICPM["check_layers"] layers, one such step against
    one with remat="none" from the same init (the losses within STEP_TOL,
    the parameters within AdamW's sign-flip bound: the embedding
    backward's atomics are not deterministic); then `steps` steps of the
    whole model, the launch counts set to 0 just before and read just
    after (no kernel is on this path: one device has no gradient sync,
    and training attention is the plain version through autograd, as in
    JAX). Each step's seconds, loss, grad norm, peak GiB and mfu; finite
    parameters after the last. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    spec = GSPMD_MINICPM
    cfg = get_config(spec["arch"]).replace(remat=spec["remat"])
    nmb, lr = spec["microbatches"], spec["lr"]
    t = time.perf_counter()
    batches = _gspmd_batches(torch, dev, cfg, spec["global_batch"],
                             spec["seq_len"], spec["steps"], GSPMD_SEED)
    data_seconds = time.perf_counter() - t
    cut = cfg.replace(n_layers=spec["check_layers"])
    state, (plain,) = _gspmd_steps(torch, dev, cut.replace(remat="none"),
                                   batches[:1], nmb, lr)
    plain_params = {k: v.detach().cpu() for k, v in state.params.items()}
    del state
    torch.cuda.empty_cache()
    state, (rematted,) = _gspmd_steps(torch, dev, cut, batches[:1], nmb, lr)
    loss_rel = abs(rematted["loss"] - plain["loss"]) / abs(plain["loss"])
    require(loss_rel < STEP_TOL[0], f"remat vs none: loss rel {loss_rel}")
    check = {"n_layers": cut.n_layers, "loss_rel": loss_rel,
             **_sign_flip_gap(torch, state.params, plain_params, lr),
             "peak_gib": {"none": plain["peak_gib"],
                          cfg.remat: rematted["peak_gib"]},
             "seconds": {"none": plain["seconds"],
                         cfg.remat: rematted["seconds"]}}
    del state, plain_params
    torch.cuda.empty_cache()
    reset_launch_counts()
    t = time.perf_counter()
    state, recs = _gspmd_steps(torch, dev, cfg, batches, nmb, lr)
    seconds = time.perf_counter() - t
    launches = launch_counts()
    _params_finite(torch, state, cfg.name)
    n_params = sum(v.numel() for v in state.params.values())
    require(state.params["blocks/wq"].shape[0] == cfg.n_layers,
            f"{cfg.name} trained {state.params['blocks/wq'].shape[0]} layers")
    emit({"phase": "train_gspmd_minicpm", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": n_params, "remat": cfg.remat,
          "seq_len": spec["seq_len"], "global_batch": spec["global_batch"],
          "microbatches": nmb, "lr": lr, "steps": recs,
          "seconds": seconds, "data_seconds": data_seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "launches": launches, "remat_vs_none": check,
          "host": _host_memory()})
    del state, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_gspmd_remat(torch, dev) -> dict:
    """qwen3-1.7b at full width and depth through `make_gspmd_train_step`:
    two steps each with remat none, full and dots from the same init at
    GSPMD_REMAT's (batch, seq_len), the largest at which "none" fits the
    card with 20 GiB to spare; each step's peak GiB and seconds; the losses within STEP_TOL
    and the parameters within AdamW's sign-flip bound of the "none"
    run's. Then one step at `long`'s sequence of 4096 and global batch
    of 16 as 8 microbatches with remat="full". The launch counts are set
    to 0 before each run and read after. Returns their sum."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    spec = GSPMD_REMAT
    cfg = get_config(spec["arch"])
    lr, n = spec["lr"], spec["steps"]
    batches = _gspmd_batches(torch, dev, cfg, spec["batch"],
                             spec["seq_len"], n, GSPMD_SEED)
    launches = {}
    runs, ref = {}, None
    for remat in ("none", "full", "dots"):
        reset_launch_counts()
        state, recs = _gspmd_steps(torch, dev, cfg.replace(remat=remat),
                                   batches, 1, lr)
        _add(launches, launch_counts())
        runs[remat] = {"steps": recs}
        if ref is None:
            ref = {k: v.detach().cpu() for k, v in state.params.items()}
        else:
            loss_rel = max(abs(r["loss"] - w["loss"]) / abs(w["loss"])
                           for r, w in zip(recs, runs["none"]["steps"]))
            require(loss_rel < STEP_TOL[0],
                    f"remat={remat} vs none: loss rel {loss_rel}")
            runs[remat]["vs_none"] = {
                "loss_rel": loss_rel,
                **_sign_flip_gap(torch, state.params, ref, lr, n)}
        del state
        torch.cuda.empty_cache()
    del ref
    long = spec["long"]
    batches = _gspmd_batches(torch, dev, cfg, long["global_batch"],
                             long["seq_len"], 1, GSPMD_SEED)
    reset_launch_counts()
    state, recs = _gspmd_steps(torch, dev, cfg.replace(remat=long["remat"]),
                               batches, long["microbatches"], lr)
    _add(launches, launch_counts())
    _params_finite(torch, state, cfg.name)
    emit({"phase": "train_gspmd_remat", "arch": cfg.name,
          "n_layers": cfg.n_layers,
          "params": sum(v.numel() for v in state.params.values()),
          "batch": spec["batch"], "seq_len": spec["seq_len"],
          "microbatches": 1, "remat": runs,
          "long": {**long, "step": recs[0]}, "launches": launches,
          "phase_seconds": time.perf_counter() - t_phase})
    del state, batches
    torch.cuda.empty_cache()
    return launches


def _serve_kernels(cfg, n_new: int) -> dict:
    """The launches a generate run of n_new tokens must make: one per layer
    in the prefill and in each of the n_new - 1 decode steps; for the dense
    and vlm decoders and hymba in bf16 at hd 64 or 128, the prefill on
    flash_prefill, the decode steps on flash_decode and none on the
    general flash_attention route. whisper's encoder layers each take one
    flash_prefill over the frames; its decoder's layers two calls a token,
    self- and cross-attention, all on flash_decode (a 4-token prompt is
    4 rows a kv head)."""
    if cfg.family == "rwkv6":
        return {"wkv": cfg.n_layers * n_new}
    if cfg.family == "whisper":
        return {"flash_attention": 0, "flash_prefill": cfg.encoder_layers,
                "flash_decode": 2 * cfg.n_layers * n_new}
    return {"flash_attention": 0, "flash_prefill": cfg.n_layers,
            "flash_decode": cfg.n_layers * (n_new - 1)}


def _serve_calls(cfg, n_new: int) -> dict:
    """The serving attention calls of a generate run, by kind: each local
    layer's prefill within its window and its decode steps over its ring
    (gemma3's local layers, every hymba layer), each global layer's over
    the whole sequence; whisper's unmasked calls (`full`: its encoder and
    every cross-attention) beside its decoder's causal ones."""
    from repro_torch.models.transformer import layer_is_global
    if cfg.family == "hymba":
        n_glob = 0
    else:
        n_glob = int(layer_is_global(cfg).sum())
    n_loc = cfg.n_layers - n_glob
    return {"prefill_windowed": n_loc, "prefill_global": n_glob,
            "decode_ring": n_loc * (n_new - 1),
            "decode_global": n_glob * (n_new - 1),
            "full": (cfg.encoder_layers + cfg.n_layers * n_new
                     if cfg.family == "whisper" else 0)}


@contextlib.contextmanager
def _attention_calls(calls: dict):
    """While it is open, the transformer's serving attention calls
    (models/attention.py) are counted into `calls` by `_serve_calls`'
    kinds."""
    from repro_torch.models import attention as attn
    names = ("prefill_attention", "decode_attention",
             "ring_decode_attention", "full_attention")
    orig = {n: getattr(attn, n) for n in names}
    for kind in ("prefill_windowed", "prefill_global", "decode_ring",
                 "decode_global", "full"):
        calls[kind] = 0

    def prefill(q, k, v, window=0):
        calls["prefill_windowed" if window > 0 else "prefill_global"] += 1
        return orig["prefill_attention"](q, k, v, window)

    def decode(*args, **kw):
        calls["decode_global"] += 1
        return orig["decode_attention"](*args, **kw)

    def ring(*args, **kw):
        calls["decode_ring"] += 1
        return orig["ring_decode_attention"](*args, **kw)

    def full(*args, **kw):
        calls["full"] += 1
        return orig["full_attention"](*args, **kw)

    for name, fn in zip(names, (prefill, decode, ring, full)):
        setattr(attn, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(attn, name, fn)


@contextlib.contextmanager
def _scan_seconds(torch, seen: dict):
    """While it is open, each call of hymba's Mamba branch
    (`models.hymba._mamba_scan`) is timed between two device syncs, and
    `seen` sums the seconds of the prefill's calls (S > 1) and of the
    decode steps'. The syncs stop the host from running ahead of the
    device across the branch, so the run is a little slower than without
    them; the split is what it is for."""
    from repro_torch.models import hymba
    orig = hymba._mamba_scan
    seen.update(prefill=0.0, decode=0.0, calls=0)

    def timed(cfg, bp, h, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(cfg, bp, h, *args)
        torch.cuda.synchronize()
        seen["prefill" if h.shape[1] > 1 else "decode"] += \
            time.perf_counter() - t
        seen["calls"] += 1
        return out

    hymba._mamba_scan = timed
    try:
        yield
    finally:
        hymba._mamba_scan = orig


@contextlib.contextmanager
def _moe_drops(torch, seen: dict):
    """While it is open, every MoE layer's routing (`models.moe.route`,
    which `moe_ffn` calls) is counted into `seen`: the prefill's
    token-expert slots (S > 1), those dropped at capacity and the
    capacity, and the decode steps' dropped slots. The counts stay on the
    device until the end, so the run is not synchronized per layer."""
    from repro_torch.models import moe
    orig = moe.route
    slots, dropped, decode_dropped = [], [], []
    seen.update(prefill_calls=0, decode_calls=0, capacity=None)

    def counted(cfg, x, router):
        r = orig(cfg, x, router)
        if x.shape[1] > 1:
            seen["prefill_calls"] += 1
            seen["capacity"] = r.cap
            slots.append(r.keep.numel())
            dropped.append((~r.keep).sum())
        else:
            seen["decode_calls"] += 1
            decode_dropped.append((~r.keep).sum())
        return r

    moe.route = counted
    try:
        yield
    finally:
        moe.route = orig
        seen["slots"] = sum(slots)
        seen["dropped"] = int(sum(dropped)) if dropped else 0
        seen["decode_dropped"] = (int(sum(decode_dropped))
                                  if decode_dropped else 0)


def phase_serve(torch, dev, spec: dict) -> dict:
    """`launch.serve.main` at full width and depth (the MoE configs with
    depth cut by the spec's `--set`); returns the launches of the path's
    kernels in that run. Each launch is also matched to its kind of call
    (a local layer's within its window and over its ring, a global one's,
    or whisper's unmasked encoder and cross-attention); for hymba the
    Mamba branch's share of the prefill and of the decode steps is timed
    (`_scan_seconds`); for the MoE configs the share of the prefill's
    token-expert slots dropped at capacity is counted (`_moe_drops`)."""
    from repro_torch.configs import get_config, parse_overrides
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import main as serve_main
    sets = spec.get("set", [])
    cfg = get_config(spec["arch"]).replace(**parse_overrides(sets))
    argv = ["--arch", spec["arch"], "--batch", str(spec["batch"]),
            "--prompt-len", str(spec["prompt_len"]),
            "--new-tokens", str(spec["new_tokens"]), "--seed", "0"]
    for kv in sets:
        argv += ["--set", kv]
    calls, scan, drops = {}, {}, {}
    reset_launch_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_attention_calls(calls))
        if cfg.family == "hymba":
            stack.enter_context(_scan_seconds(torch, scan))
        if cfg.family == "moe":
            stack.enter_context(_moe_drops(torch, drops))
        tokens, log = serve_main(argv)
    torch.cuda.synchronize()
    if cfg.family == "moe":
        require(drops["prefill_calls"] == cfg.n_layers
                and drops["decode_calls"] == cfg.n_layers
                * (spec["new_tokens"] - 1),
                f"{cfg.name}: moe_ffn calls {drops}")
        log["moe_prefill_drops"] = {
            "slots": drops["slots"], "dropped": drops["dropped"],
            "share": drops["dropped"] / drops["slots"],
            "capacity": drops["capacity"],
            "decode_dropped": drops["decode_dropped"]}
    if scan:
        require(scan["calls"] == cfg.n_layers * spec["new_tokens"],
                f"{cfg.name}: {scan['calls']} Mamba scans")
        log["mamba_scan"] = {
            "prefill_seconds": scan["prefill"],
            "prefill_share": scan["prefill"] / log["prefill_seconds"],
            "decode_seconds": scan["decode"],
            "decode_share": scan["decode"] / log["decode_seconds"],
            "timed_between_syncs": True}
    counts = launch_counts()
    want = _serve_kernels(cfg, spec["new_tokens"])
    launches = {k: counts[k] for k in want}
    if cfg.family != "rwkv6":
        want_calls = _serve_calls(cfg, spec["new_tokens"])
        require(calls == want_calls, f"{cfg.name}: attention calls {calls}, "
                f"not {want_calls}")
        log["calls_by_layer"] = calls
    require(tuple(tokens.shape) == (spec["batch"], spec["new_tokens"]),
            f"{cfg.name}: tokens {tuple(tokens.shape)}")
    require(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
            f"{cfg.name}: a token outside the vocabulary")
    require(log["logits_finite"], f"{cfg.name}: non-finite logits")
    require(launches == want, f"{cfg.name}: launches {launches}, not "
            f"{want} (one per layer per prefill and decode step)")
    if cfg.family == "hymba":
        # the rings wrap in the prefill: the prompt is longer than them
        require(spec["prompt_len"] > cfg.hymba_window,
                f"{cfg.name}: the prompt does not wrap the rings")
    name = spec["arch"].split("-")[0] + ("vl" if cfg.family == "vlm" else "")
    emit({"phase": spec.get("phase", "serve_" + name), "argv": argv,
          **log, "kernel_launches": launches})
    del tokens
    torch.cuda.empty_cache()
    return launches


def phase_reference(torch, dev) -> None:
    """The smoke configs of the dense and vlm decoders, hymba, the MoE
    decoders and rwkv6 (its recurrence through the training scan), the
    same parameters on the card and on the CPU: the card's degraded (OptCC) run
    equals its healthy (psum) run, as on 8 JAX devices in
    tests/multidev_driver.py, and the CPU's plain-PyTorch run. One line per
    config; then the loss and gradients of qwen2-vl with a patch prefix
    and of whisper with its frames."""
    for arch in REFERENCE_ARCHS:
        _reference_run(torch, dev, arch)
    _loss_run(torch, dev, "qwen2-vl-2b")
    _loss_run(torch, dev, "whisper-base")


# the card-vs-CPU limit on each gradient leaf, norm-wise: the sum of two
# fp32 runs' errors, up to 1e-4 of a leaf's norm for qwen2-vl-smoke
# (tests/test_torch_dense_configs.py) and, on this run's batch (labels
# equal to the tokens), up to 1.8e-3 for whisper-smoke: the CPU's own fp32
# gradients against a float64 run (tools/fp32_conditioning.py
# --chip-batch)
LOSS_RUN_GRAD_TOL = {"qwen2-vl-2b": 2e-4, "whisper-base": 4e-3}


def _loss_run(torch, dev, arch: str) -> None:
    """A smoke config's loss and gradients, card against CPU, on a batch
    with its extras: qwen2-vl's patch prefix (8 standard-normal
    embeddings before 24 tokens, their labels masked) and unequal (t, h,
    w) ids; whisper's 24 standard-normal frames. Loss rel within STEP_TOL,
    each gradient leaf within LOSS_RUN_GRAD_TOL of its norm."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    init = model.init(8, "cpu")
    rng = np.random.default_rng(8)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).long()
    batch = {"tokens": toks, "labels": toks.clone()}
    if cfg.family == "vlm":
        P = cfg.n_patch_tokens
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32))
        batch["positions"] = torch.from_numpy(rng.integers(
            0, 64, (B, P + S, 3))).long()
        shapes = {"tokens": [B, S], "prefix_embeds": [B, P, cfg.d_model],
                  "positions": "random (t, h, w) ids"}
    else:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
        shapes = {"tokens": [B, S],
                  "frames": [B, cfg.n_audio_frames, cfg.d_model]}
    runs = []                  # the card's, then the CPU's
    for device in (dev, torch.device("cpu")):
        params = {k: v.detach().clone().to(device).requires_grad_(True)
                  for k, v in init.items()}
        loss = model.loss(params, {k: v.to(device) for k, v in
                                   batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
        runs.append((float(loss.detach()), [g.cpu() for g in grads]))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = runs
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grads_abs = max(float((a - b).abs().max())
                    for a, b in zip(card_grads, cpu_grads))
    grads_rel = max(float((a - b).norm() / b.norm())
                    for a, b in zip(card_grads, cpu_grads))
    tol = LOSS_RUN_GRAD_TOL[arch]
    require(loss_rel < STEP_TOL[0] and grads_rel <= tol,
            f"{cfg.name} loss card vs CPU: {loss_rel}, {grads_rel}")
    emit({"phase": "reference_" + ("prefix" if cfg.family == "vlm"
                                   else "frames"),
          "config": cfg.name, "batch": shapes,
          "loss": card_loss, "card_vs_cpu": {
              "loss_rel": loss_rel, "grads_norm_rel": grads_rel,
              "grads_abs": grads_abs},
          "limits": {"loss_rel": STEP_TOL[0], "grads_norm_rel": tol}})


def _reference_run(torch, dev, arch: str) -> None:
    from repro_torch.comms import LocalTransport
    from repro_torch.comms.fault import FaultState
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.schedules import constant
    from repro_torch.train import TrainState, make_dp_failover_step

    cfg = get_config(arch, smoke=True)
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
                                     constant(REFERENCE_LR), fault)
        losses = []
        for i in range(REFERENCE_STEPS):
            batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                     for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs[name] = (losses, {k: v.detach().cpu() for k, v in
                               state.params.items()})

    def gap(a, b):
        """loss rel (the largest; the first step's), params max abs, and
        the count of params past STEP_TOL's abs limit"""
        dl = [abs(x - y) / abs(y) for x, y in zip(runs[a][0], runs[b][0])]
        diffs = [(runs[a][1][k] - runs[b][1][k]).abs() for k in runs[a][1]]
        return (max(dl), max(float(d.max()) for d in diffs),
                sum(int((d > STEP_TOL[1]).sum()) for d in diffs), dl[0])

    hd = gap("cuda_degraded", "cuda_healthy")
    cd = gap("cuda_degraded", "cpu_degraded")
    n = sum(v.numel() for v in runs["cpu_degraded"][1].values())
    bound = 2 * REFERENCE_LR * REFERENCE_STEPS
    if cfg.family == "moe":
        # the MoE smoke runs are chaotic after their first step: a
        # rounding-sized difference moves whole tokens between experts
        # (an init nudged by one fp32 rounding moves phi35-moe-smoke's
        # third loss by 2.4e-4 and leaves 41 % of a leaf past 1e-4,
        # tools/fp32_conditioning.py --perturb; tests/test_torch_moe.py).
        # So the first step's loss is held to STEP_TOL, the later ones to
        # 1e-3, and every parameter to the 2 lr a step bound
        for what, g in (("healthy vs degraded", hd), ("card vs CPU", cd)):
            require(g[3] < STEP_TOL[0] and g[0] < 1e-3 and g[1] <= bound,
                    f"{what}: {g} of {n} params")
        limits = {"first_loss_rel": STEP_TOL[0], "loss_rel": 1e-3,
                  "params_abs": bound}
    elif arch in ("qwen3-1.7b", "gemma3-27b"):
        # healthy vs degraded on one card: the limits of the JAX multidev
        # check; card vs CPU: STEP_TOL
        require(hd[0] < 1e-5 and hd[1] < 1e-5, f"healthy vs degraded: {hd}")
        require(cd[0] < STEP_TOL[0] and cd[1] < STEP_TOL[1],
                f"card vs CPU: {cd}")
        limits = {"healthy_vs_degraded": (1e-5, 1e-5), "card_vs_cpu": STEP_TOL}
    else:
        # internlm2, minicpm, qwen2-vl and hymba: their smoke gradients are
        # poorly conditioned (fp32 errors up to 1e-4 of a leaf's norm,
        # tests/test_torch_dense_configs.py; hymba's grad norm after a step
        # up to 3e-4 from float64, tests/test_torch_hymba.py), and AdamW's
        # per-element normalisation turns an error in a gradient element
        # near 0 into an update of the other sign: such a parameter parts
        # by at most 2 lr a step. On the CPU, this run in fp32 leaves 0.20 % of minicpm-smoke's
        # parameters more than 1e-4 from the same run in float64 (up to
        # 1.4e-3), and the card leaves 0.29 % that far from the CPU; a wrong
        # gradient would move about half. So the losses are held to
        # STEP_TOL, every parameter to the 2 lr a step bound, and at most
        # 1 % of them past STEP_TOL's abs limit, in both comparisons (rwkv6
        # too: tests/test_torch_rwkv6_train.py holds it to JAX so)
        for what, g in (("healthy vs degraded", hd), ("card vs CPU", cd)):
            require(g[0] < STEP_TOL[0] and g[1] <= bound
                    and g[2] <= 0.01 * n, f"{what}: {g} of {n} params")
        limits = {"loss_rel": STEP_TOL[0], "params_abs": bound,
                  "params_past_abs": [STEP_TOL[1], 0.01 * n]}
    emit({"phase": "reference", "config": cfg.name,
          "losses": {k: v[0] for k, v in runs.items()},
          "healthy_vs_degraded": {"loss_rel": hd[0], "params_abs": hd[1],
                                  "params_past_abs_limit": hd[2]},
          "card_vs_cpu": {"loss_rel": cd[0], "params_abs": cd[1],
                          "params_past_abs_limit": cd[2]},
          "limits": limits})


def _attention_f64(torch, q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_len=None):
    """The plain version's attention (the same masks) in float64: the
    yardstick of the kernel's and the plain version's fp32 rounding."""
    B, Sq, H, hd = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    rep = H // k.shape[2]
    kk = k[:, :kv_len].double().repeat_interleave(rep, 2)
    vv = v[:, :kv_len].double().repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / math.sqrt(hd)
    iq = q_offset + torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(kv_len, device=q.device)[None, :]
    ok = torch.ones((Sq, kv_len), dtype=torch.bool, device=q.device)
    if causal:
        ok &= jk <= iq
    if window > 0:
        ok &= jk > iq - window
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


@contextlib.contextmanager
def _held_to_plain(torch, seen: dict):
    """While it is open, every serving attention call (models/attention.py's
    flash op) at head dim 12, which must take the general route, is also run
    through the plain version and compared at FLASH_TOL (fp32; plus one
    bf16 ulp in bf16); `seen` gets the count of such calls and their max
    error. The plain runs launch nothing.

    An output element is a convex combination of value rows, so its fp32
    rounding scales with |v|, not with itself: at the hd-12 smoke configs'
    |q|, |k|, |v| ~ 20 (their init scales a layer's weights by 1/sqrt(L))
    the plain version itself parts from a float64 run by more than the
    limit allows near an output of 0, and so may the kernel. An fp32 call
    past the limit is then held to the float64 attention instead, at the
    fp32 limit on the scale of the values it averages: each element within
    FLASH_TOL (1 + max |v|) of it; `seen["held_to_float64"]` lists such
    calls with the kernel's gap to float64 and the plain version's."""
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.models import attention as attn
    orig = attn.flash_attention
    seen.update(calls=0, max_abs_err=0.0, held_to_float64=[])

    def held(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if q.shape[-1] == 12:
            require(kernel.pick_route(q, k, v) == "flash_attention",
                    "an hd-12 call left the general route")
            want = ref.flash_attention_ref(q, k, v, **kw)
            what = f"hd 12 serving call {tuple(q.shape)} {kw}"
            try:
                err = _compare(torch, out, want, what, FLASH_TOL["float32"],
                               ulp=q.dtype == torch.bfloat16)
            except AssertionError:
                if q.dtype != torch.float32:
                    raise
                truth = _attention_f64(torch, q, k, v, **kw)
                gaps = [float((x.double() - truth).abs().max())
                        for x in (out, want)]
                limit = FLASH_TOL["float32"] * (1 + float(v.abs().max()))
                require(gaps[0] <= limit, f"{what}: the kernel is {gaps[0]} "
                        f"from float64 (limit {limit}), the plain version "
                        f"{gaps[1]}")
                seen["held_to_float64"].append(
                    {"q": list(q.shape), "kernel_gap": gaps[0],
                     "plain_gap": gaps[1], "limit": limit})
                err = float((out - want).abs().max())
            seen["max_abs_err"] = max(seen["max_abs_err"], err)
            seen["calls"] += 1
        return out

    attn.flash_attention = held
    try:
        yield
    finally:
        attn.flash_attention = orig


def _smoke_serve_launches(cfg, n_new: int) -> dict:
    """The flash launches of a smoke config's generate run (fp32, a
    12-token prompt, n_new tokens): a prompt of 12 x rep > 16 rows a kv
    head on the general route and each decode step on flash_decode; every
    call at hd 12 on the general route (flash_decode has no hd-12
    template: minicpm, qwen2-vl, hymba); whisper's encoder (24 frames a
    kv head) on the general route, and its 12-row prompt and every
    cross-attention on flash_decode."""
    from repro_torch.kernels.flash_attention import kernel
    L = cfg.n_layers
    if cfg.hd not in kernel.DECODE_HEAD_DIMS:
        return {"flash_attention": L * n_new, "flash_prefill": 0,
                "flash_decode": 0}
    if cfg.family == "whisper":
        return {"flash_attention": cfg.encoder_layers, "flash_prefill": 0,
                "flash_decode": 2 * L * n_new}
    return {"flash_attention": L, "flash_prefill": 0,
            "flash_decode": L * (n_new - 1)}


def _smoke_forward_logits(torch, cfg, params, toks, extras):
    """fp32 logits of the teacher-forced `forward` at every position."""
    from repro_torch.models import hymba, rwkv6, transformer, whisper
    if cfg.family == "rwkv6":
        h = rwkv6.forward(cfg, params, toks)
    elif cfg.family == "hymba":
        h = hymba.forward(cfg, params, toks)
    elif cfg.family == "whisper":
        h = whisper.forward(cfg, params, toks, extras["frames"])
    else:
        h = transformer.forward(cfg, params, toks)
        return h.float() @ transformer.unembed_matrix(cfg, params).float()
    return h.float() @ params["lm_head"].float()


def phase_serve_reference(torch, dev) -> dict:
    """The ten smoke configs, the same parameters on the card and on the
    CPU: greedy tokens equal, and on the card the prefill logits and every
    decode step's logits equal `forward`'s at the same position (the
    windows of 16 of gemma3 and hymba are passed at position 16, so their
    rings wrap; whisper's 24 frames are standard normal; the MoE configs
    at capacity factor 8, where nothing drops). The fp32 smoke
    prefills (hd 16, and hd 12 for minicpm, qwen2-vl and hymba) are the
    general flash_attention route's path, and at hd 12 so are the decode
    steps, each call held to the plain version (`_held_to_plain`); whisper
    also puts its encoder there and its cross-attention on flash_decode
    (`_smoke_serve_launches`). Returns the general route's launches in the
    card's generate runs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.train.serve import generate, pad_cache_to
    out = {}
    n_general = 0
    hd12 = {}
    B, prompt_len, total = 2, 12, 24
    for arch in SERVE_REFERENCE_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        cpu_params = model.init(5, "cpu")
        params = {k: v.to(dev) for k, v in cpu_params.items()}
        rng = np.random.default_rng(5)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, total))).long()
        extras = {}
        if cfg.family == "whisper":
            extras["frames"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
        want = generate(model, cpu_params, toks[:, :prompt_len], 8, extras)
        extras = {k: v.to(dev) for k, v in extras.items()}
        reset_launch_counts()
        seen = {}
        with _held_to_plain(torch, seen):
            got = generate(model, params, toks[:, :prompt_len].to(dev), 8,
                           extras)
        torch.cuda.synchronize()
        counts = launch_counts()
        require(torch.equal(got.cpu(), want), f"{cfg.name}: card tokens "
                f"{got.tolist()} != CPU tokens {want.tolist()}")
        if cfg.family != "rwkv6":
            n_general += counts["flash_attention"]
            expect = _smoke_serve_launches(cfg, 8)
            require({k: counts[k] for k in expect} == expect,
                    f"{cfg.name}: launches {counts}, not {expect}")
            if cfg.hd == 12:
                require(seen["calls"] == cfg.n_layers * 8,
                        f"{cfg.name}: {seen['calls']} hd-12 calls held")
                hd12[cfg.name] = seen
        toks = toks.to(dev)
        if cfg.family == "moe":
            # capacity drops depend on the sequence length the router
            # sees, so prefill(S/2) and forward(S) differ under drops: held
            # without drops, at capacity factor 8, as
            # tests/test_serve_equivalence.py holds them
            cfg = cfg.replace(capacity_factor=8.0)
            model = build_model(cfg)
        with torch.no_grad():
            full = _smoke_forward_logits(torch, cfg, params, toks, extras)
            logits, cache = model.prefill(
                params, {"tokens": toks[:, :prompt_len], **extras})
            err = _compare(torch, logits, full[:, prompt_len - 1],
                           f"{cfg.name} prefill vs forward", SERVE_TOL)
            cache = pad_cache_to(cache, total, keys=(
                ("k", "v") if cfg.family == "whisper" else None))
            for pos in range(prompt_len, total):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
                err = max(err, _compare(
                    torch, lg, full[:, pos],
                    f"{cfg.name} decode vs forward at {pos}", SERVE_TOL))
        out[cfg.name] = {"tokens_equal": True, "logits_max_abs_err": err}
    require(len(hd12) == 3, f"hd-12 configs held: {sorted(hd12)}")
    emit({"phase": "serve_reference", "limit": SERVE_TOL, **out,
          "flash_attention_launches": n_general,
          "general_route_hd12": {**hd12, "limit": FLASH_TOL["float32"]}})
    return {"flash_attention": n_general}


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


# kernels whose `device_ms` came from per-call CUDA events, because no
# profiler capture recorded them (reported in the timing phases' lines)
DEVICE_MS_FROM_EVENTS: list = []
PROFILER_TRIES = 3


def _device_ms(torch, fn, iters: int, kernel: str) -> float:
    """The device time per call of `kernel`'s CUDA kernels, from
    torch.profiler's record of `iters` calls after one warm-up call: the
    kernels alone, without the host's work between launches. Each of the
    matching kernels runs once a call, so each one's total is divided by
    the launches the profiler recorded of it, not by `iters`: on an H100
    it once recorded 4 of 5 calls, and the W-way form's time per call
    then read below its byte bound. A capture that records none of the
    kernels (once on an H100, for 10 wkv decode calls) is made again, up
    to PROFILER_TRIES times; if none records them, each call is timed
    alone between two CUDA events, which adds the launch latency, and
    the kernel is listed in DEVICE_MS_FROM_EVENTS."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if KERNEL_SYMBOLS[kernel] in e.key and e.device_time_total > 0]
        if found:
            return sum(e.device_time_total / e.count for e in found) / 1e3
    print(f"chip_smoke: {PROFILER_TRIES} profiler captures recorded no device "
          f"time for {kernel}; timing each call with CUDA events",
          file=sys.stderr, flush=True)
    DEVICE_MS_FROM_EVENTS.append(kernel)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _bound(bytes_moved: int, flops: int, peak: float = FP32_FLOPS) -> dict:
    """Least time for the work: the larger of its bytes (each input read
    once, each output written once) at the memory rate and its operations
    at the card's peak for their type (fp32 by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(torch, dev, n_grad: int, internlm2: dict, hymba: dict,
                 phi35moe: dict, errs) -> dict:
    """Both forms at the main path's shapes: the healthy step's W=4 psum of
    the bf16 gradient vector (and the W=2 one of the elastic run's 2
    members), and one degraded reduce-scatter hop (three fp32 chunk pairs
    of the padded vector, p=4, straggler 1); both also at internlm2-1.8b's
    gradient length (whose chunks, padded only to a multiple of 3, would
    have an odd length) and at hymba-1.5b's (the healthy sync's bf16
    buffer and its fp32 one; the degraded sync's one fp32 buffer of
    both) and at one-layer phi3.5-moe's (its bf16 experts' and fp32
    router's buffers, and the pair form at their sum). `internlm2`,
    `hymba` and `phi35moe` are their gradient element counts by dtype.
    The process transport's combines at qwen3's length: the W-way form on
    a rank's (4, n/4) psum stack, the pair form on a staged row."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    n_internlm2, n_hymba = sum(internlm2.values()), sum(hymba.values())
    out["chunk_reduce"] = _wway_timing(torch, gen, dev, 4, n_grad, errs)
    out["chunk_reduce_w2"] = _wway_timing(torch, gen, dev, 2, n_grad, errs)
    out["chunk_reduce_internlm2"] = _wway_timing(torch, gen, dev, 4,
                                                 n_internlm2, errs)
    for dtype, n in sorted(hymba.items()):
        out[f"chunk_reduce_hymba_{dtype}"] = _wway_timing(
            torch, gen, dev, 4, n, errs, getattr(torch, dtype))
    out["chunk_reduce_pairs"] = _pairs_timing(torch, gen, dev, n_grad, errs)
    out["chunk_reduce_pairs_internlm2"] = _pairs_timing(
        torch, gen, dev, n_internlm2, errs)
    out["chunk_reduce_pairs_hymba"] = _pairs_timing(torch, gen, dev, n_hymba,
                                                    errs)
    for dtype, n in sorted(phi35moe.items()):
        out[f"chunk_reduce_phi35moe_{dtype}"] = _wway_timing(
            torch, gen, dev, 4, n, errs, getattr(torch, dtype))
    out["chunk_reduce_pairs_phi35moe"] = _pairs_timing(
        torch, gen, dev, sum(phi35moe.values()), errs)
    # the process transport's combines: a rank's W-way psum of its (4, n/4)
    # stack, and the pair form adding its staging row
    out["chunk_reduce_dist"] = _wway_timing(torch, gen, dev, 4,
                                            -(-n_grad // 4), errs)
    out["chunk_reduce_pairs_staged"] = _staged_pair_timing(torch, gen, dev,
                                                           n_grad, errs)
    emit({"phase": "timing", **out,
          "device_ms_from_events": list(DEVICE_MS_FROM_EVENTS)})
    return {k: {f: v[f] for f in LINE_FIELDS} for k, v in out.items()}


def _wway_timing(torch, gen, dev, W: int, n: int, errs,
                 dtype=None) -> dict:
    """The healthy sync's W-way sum of a (W, n) stack (bf16 unless
    `dtype`), against its plain version, timed."""
    from repro_torch.kernels.chunk_reduce import ops, ref
    dtype = dtype or torch.bfloat16
    parts = torch.randn((W, n), generator=gen, device=dev, dtype=dtype)
    got = ops.chunk_reduce(parts)
    errs["chunk_reduce"] = max(errs["chunk_reduce"], _compare(
        torch, got, ref.chunk_reduce_ref(parts), f"W-way W={W} N={n}"))
    del got
    res = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce(parts), 10),
        "device_ms": _device_ms(torch, lambda: ops.chunk_reduce(parts), 5,
                                "chunk_reduce"),
        "plain_ms": _cuda_ms(torch, lambda: ref.chunk_reduce_ref(parts), 5),
        **_bound((W + 1) * n * parts.element_size(), (W - 1) * n),
        "library_ms": _cuda_ms(torch, lambda: parts.sum(0), 10),
        "shape": [W, n], "dtype": str(dtype).removeprefix("torch.")}
    del parts
    torch.cuda.empty_cache()
    return res


def _pairs_timing(torch, gen, dev, n_grad: int, errs) -> dict:
    """One degraded reduce-scatter hop of an n_grad-element gradient: three
    fp32 chunk pairs in `optcc_allreduce_tree`'s layout (p=4, straggler 1):
    JAX's chunks of c (the vector padded to a multiple of p - 1), each in
    a row of whole 16-byte vectors; against its plain version to the bit,
    timed."""
    from repro_torch.comms.transport import row_width
    from repro_torch.kernels.chunk_reduce import ops, ref
    p, ph = 4, 3
    c = (n_grad + (-n_grad) % ph) // ph
    w = row_width(c, torch.float32)
    buf = torch.randn((p * ph, w), generator=gen, device=dev)
    ring = [0, 2, 3]          # healthy members with straggler 1
    dst = [ring[(i + 1) % ph] * ph + i for i in range(ph)]
    src = [ring[i] * ph + i for i in range(ph)]
    want = torch.stack([buf[d] + buf[s] for d, s in zip(dst, src)])
    ops.chunk_reduce_pairs_(buf, dst, src)
    errs["chunk_reduce_pairs"] = max(errs["chunk_reduce_pairs"], _compare(
        torch, buf[dst], want, f"pairs at N={n_grad}"))
    require(torch.equal(buf[dst], want), f"pairs at N={n_grad}: not "
            "bit-equal to the plain version")
    del want
    torch.cuda.empty_cache()

    def library():
        for d, s in zip(dst, src):
            buf[d].add_(buf[s])

    res = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce_pairs_(buf, dst, src),
                       10),
        "device_ms": _device_ms(
            torch, lambda: ops.chunk_reduce_pairs_(buf, dst, src), 5,
            "chunk_reduce_pairs"),
        "plain_ms": _cuda_ms(
            torch, lambda: ref.chunk_reduce_pairs_ref_(buf, dst, src), 5),
        **_bound(3 * ph * w * buf.element_size(), ph * w),
        "library_ms": _cuda_ms(torch, library, 10),
        "shape": [p * ph, w], "pairs": ph, "dtype": "float32",
        "bit_equal": True, "chunk": c, "chunk_mod_4": c % 4}
    del buf
    torch.cuda.empty_cache()
    return res


def _staged_pair_timing(torch, gen, dev, n_grad: int, errs) -> dict:
    """The process transport's combine of one received OptCC chunk: one
    pair, the staging row (the buffer's last) into one of a rank's three
    chunk rows of an n_grad-element fp32 gradient (p=4), against its plain
    version to the bit, timed; `add_` of the two rows is the library
    call."""
    from repro_torch.comms.transport import row_width
    from repro_torch.kernels.chunk_reduce import ops, ref
    ph = 3
    c = (n_grad + (-n_grad) % ph) // ph
    w = row_width(c, torch.float32)
    buf = torch.randn((ph + 1, w), generator=gen, device=dev)
    want = buf[1] + buf[ph]
    ops.chunk_reduce_pairs_(buf, [1], [ph])
    errs["chunk_reduce_pairs"] = max(errs["chunk_reduce_pairs"], _compare(
        torch, buf[1], want, f"staged pair at N={n_grad}"))
    require(torch.equal(buf[1], want), "staged pair not bit-equal")
    del want
    res = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce_pairs_(buf, [1], [ph]),
                       10),
        "device_ms": _device_ms(
            torch, lambda: ops.chunk_reduce_pairs_(buf, [1], [ph]), 5,
            "chunk_reduce_pairs"),
        "plain_ms": _cuda_ms(
            torch, lambda: ref.chunk_reduce_pairs_ref_(buf, [1], [ph]), 5),
        **_bound(3 * w * buf.element_size(), w),
        "library_ms": _cuda_ms(torch, lambda: buf[1].add_(buf[ph]), 10),
        "shape": [ph + 1, w], "pairs": 1, "dtype": "float32",
        "bit_equal": True}
    del buf
    torch.cuda.empty_cache()
    return res


def _flash_timing(torch, q, k, v, *, route: str, q_offset: int,
                  kv_len: int, causal: bool, iters: int,
                  window: int = 0) -> dict:
    """One flash route at one shape: kernel, plain version, SDPA (the
    library call: GQA, causal only for the prefill; a window as an explicit
    boolean mask) and the bound: q, the first kv_len keys and values, the
    output; 4 hd flops per visible (query, key) pair, at the tensor-core
    bf16 rate for bf16 inputs and at ATTN_FP32_FLOPS for fp32 ones
    (3xTF32), the bound by fp32 FMAs beside it (`bound_fp32_fma_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    require(kernel.pick_route(q, k, v) == route,
            f"timing: {route} is not the route of {tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    kk, vv = k[:, :kv_len], v[:, :kv_len]
    qt, kt, vt = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
    sdpa = dict(is_causal=causal and Sq > 1, enable_gqa=True)
    if window > 0:
        iq = q_offset + torch.arange(Sq, device=q.device)[:, None]
        jk = torch.arange(kv_len, device=q.device)[None, :]
        ok = jk > iq - window
        sdpa = dict(attn_mask=ok & (jk <= iq) if causal else ok,
                    enable_gqa=True)
    flops, nbytes = kernel.work(q, k, v, **kw)
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
            qt, kt, vt, **sdpa), iters),
        "shape": {"q": list(q.shape), "kv": [B, kv_len] + list(k.shape[2:]),
                  "q_offset": q_offset, "causal": causal, "window": window},
        "dtype": str(q.dtype).removeprefix("torch.")}


def _timed_call(torch, errs, what, q, k, v, *, route: str, causal: bool,
                q_offset: int, kv_len: int, iters: int = 200) -> dict:
    """One flash call checked against its plain version (the fp32 limit
    plus one bf16 ulp), then `_flash_timing` at its shape."""
    from repro_torch.kernels.flash_attention import ops, ref
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    out = ops.flash_attention(q, k, v, **kw)
    errs[route] = max(errs[route], _compare(
        torch, out, ref.flash_attention_ref(q, k, v, **kw), f"timed {what}",
        FLASH_TOL["float32"], ulp=True))
    res = _flash_timing(torch, q, k, v, route=route, iters=iters, **kw)
    torch.cuda.empty_cache()
    return res


def _wkv_timing(torch, x, state0, iters: int) -> dict:
    """wkv at one shape: kernel (CUDA events over back-to-back calls of the
    op, host included, and its device time), plain version, no library call
    (no one PyTorch call computes the recurrence), and the bound: r, k, v,
    w, u, state0 in and out and the final state; 7 fp32 flops per state
    element per token."""
    from repro_torch.kernels.wkv import kernel, ops, ref
    B, S, H, hd = x[0].shape
    return {
        "ms": _cuda_ms(torch, lambda: ops.wkv(*x, state0), iters),
        "device_ms": _device_ms(torch, lambda: ops.wkv(*x, state0),
                                min(iters, 10), "wkv"),
        "plain_ms": _cuda_ms(torch, lambda: ref.wkv_ref(*x, state0), 1,
                             warmup=1),
        **_bound(*reversed(kernel.work(*x, state0))),
        "library_ms": None,
        "shape": [B, S, H, hd], "state0": state0 is not None,
        "dtype": "float32"}


def phase_serve_timing(torch, dev, errs) -> dict:
    """The three flash routes at qwen3-1.7b's shapes: flash_prefill at the
    bf16 prefill, flash_decode at a mid-decode step, the general
    flash_attention route at the same prefill in fp32 (its route: fp32
    prompts), and the general route at the smoke configs' head dims at a
    realistic length, (8, 2048, 4/2, 16) and (8, 2048, 6/6, 12), in fp32
    and bf16; flash_prefill and flash_decode at gemma3-27b's local prefill
    (window 1024) and ring decode (1024 slots) and at minicpm-2b's and
    qwen2-vl-2b's prefill and mid-decode step; hymba-1.5b's windowed
    prefill and ring decode and whisper-base's encoder, cross-attention
    (prompt and decode step) and self-attention decode step; phi3.5-moe's
    and arctic-480b's prefill and mid-decode step (4 and 7 query heads a
    kv head); wkv at
    rwkv6-7b's prefill and decode shapes. The `kernels` line takes
    flash_decode's decode shape, the general route's qwen3 fp32 prefill and
    wkv's prefill shape."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.wkv import ops as wops
    from repro_torch.kernels.wkv import ref as wref
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S, H, KV, hd = _attn_shape(SERVE_QWEN3)

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
             "flash_attention", (4, 2, 16), 20),
            ("flash_attention_hd12_float32", torch.float32,
             "flash_attention", (6, 6, 12), 20),
            ("flash_attention_hd12_bfloat16", torch.bfloat16,
             "flash_attention", (6, 6, 12), 20)):
        q, k, v = (rand((B, S, Hh, hdh), dtype),
                   rand((B, S, KVh, hdh), dtype),
                   rand((B, S, KVh, hdh), dtype))
        out = fops.flash_attention(q, k, v)
        errs[route] = max(errs[route], _compare(
            torch, out, fref.flash_attention_ref(q, k, v),
            f"timed prefill {name}", FLASH_TOL["float32"], ulp=True))
        res[name] = _flash_timing(torch, q, k, v, route=route,
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
        torch, q, kc, vc, route="flash_decode", q_offset=pos,
        kv_len=pos + 1, causal=True, iters=200)
    del kc, vc, q, out
    torch.cuda.empty_cache()

    # gemma3-27b's local layers: the prefill within the window, and a
    # decode step over a full ring (non-causal over its window of slots)
    Bg, Sg, Hg, KVg, hdg, w = _gemma3_attn_shape()
    q, k, v = (rand((Bg, Sg, Hg, hdg)), rand((Bg, Sg, KVg, hdg)),
               rand((Bg, Sg, KVg, hdg)))
    out = fops.flash_attention(q, k, v, window=w)
    errs["flash_prefill"] = max(errs["flash_prefill"], _compare(
        torch, out, fref.flash_attention_ref(q, k, v, window=w),
        "timed gemma3 local prefill", FLASH_TOL["float32"], ulp=True))
    res["gemma3_local_prefill"] = _flash_timing(
        torch, q, k, v, route="flash_prefill", q_offset=0, kv_len=Sg,
        causal=True, iters=20, window=w)
    del q, k, v, out
    torch.cuda.empty_cache()
    ring_k, ring_v = rand((Bg, w, KVg, hdg)), rand((Bg, w, KVg, hdg))
    q = rand((Bg, 1, Hg, hdg))
    out = fops.flash_attention(q, ring_k, ring_v, causal=False)
    errs["flash_decode"] = max(errs["flash_decode"], _compare(
        torch, out, fref.flash_attention_ref(q, ring_k, ring_v,
                                             causal=False),
        "timed gemma3 ring decode", FLASH_TOL["float32"], ulp=True))
    res["gemma3_ring_decode"] = _flash_timing(
        torch, q, ring_k, ring_v, route="flash_decode", q_offset=0,
        kv_len=w, causal=False, iters=200)
    del ring_k, ring_v, q, out
    torch.cuda.empty_cache()

    # minicpm-2b's and qwen2-vl-2b's serve shapes: the bf16 prefill on
    # flash_prefill (rep 1 at hd 64; rep 6 at hd 128) and a mid-decode step
    # (kv_len 2081) on flash_decode, with its split count
    from repro_torch.kernels.flash_attention import kernel as fkernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, spec in (("minicpm", SERVE_MINICPM), ("qwen2vl", SERVE_QWEN2VL)):
        Bm, Sm, Hm, KVm, hdm = _attn_shape(spec)
        q, k, v = (rand((Bm, Sm, Hm, hdm)), rand((Bm, Sm, KVm, hdm)),
                   rand((Bm, Sm, KVm, hdm)))
        out = fops.flash_attention(q, k, v)
        errs["flash_prefill"] = max(errs["flash_prefill"], _compare(
            torch, out, fref.flash_attention_ref(q, k, v),
            f"timed {tag} prefill", FLASH_TOL["float32"], ulp=True))
        res[f"{tag}_prefill"] = _flash_timing(
            torch, q, k, v, route="flash_prefill", q_offset=0,
            kv_len=Sm, causal=True, iters=20)
        del q, k, v, out
        torch.cuda.empty_cache()
        n_new = spec["new_tokens"]
        kc, vc = (rand((Bm, Sm + n_new, KVm, hdm)) for _ in range(2))
        q = rand((Bm, 1, Hm, hdm))
        pos = Sm + n_new // 2
        out = fops.flash_attention(q, kc, vc, q_offset=pos, kv_len=pos + 1)
        errs["flash_decode"] = max(errs["flash_decode"], _compare(
            torch, out, fref.flash_attention_ref(q, kc, vc, q_offset=pos,
                                                 kv_len=pos + 1),
            f"timed {tag} decode", FLASH_TOL["float32"], ulp=True))
        res[f"{tag}_decode"] = _flash_timing(
            torch, q, kc, vc, route="flash_decode", q_offset=pos,
            kv_len=pos + 1, causal=True, iters=200)
        res[f"{tag}_decode"]["decode_splits"] = fkernel.decode_splits(
            pos + 1, Bm * KVm, sms)
        del kc, vc, q, out
        torch.cuda.empty_cache()

    # hymba-1.5b: the windowed prefill (25/5 heads, hd 64, window 1024)
    # and a decode step of 5 rows a kv head over a full 1024-slot ring;
    # whisper-base: the encoder's non-causal prefill over 1500 frames, the
    # cross-attention of the 4-token prompt and of a decode step over
    # them, and a mid-run self-attention decode step (kv_len 116)
    cfg = _serve_cfg(SERVE_HYMBA)
    Bh, Sh, w = SERVE_HYMBA["batch"], SERVE_HYMBA["prompt_len"], \
        cfg.hymba_window
    Hh, KVh, hdh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (rand((Bh, Sh, Hh, hdh)), rand((Bh, Sh, KVh, hdh)),
               rand((Bh, Sh, KVh, hdh)))
    out = fops.flash_attention(q, k, v, window=w)
    errs["flash_prefill"] = max(errs["flash_prefill"], _compare(
        torch, out, fref.flash_attention_ref(q, k, v, window=w),
        "timed hymba prefill", FLASH_TOL["float32"], ulp=True))
    res["hymba_prefill"] = _flash_timing(
        torch, q, k, v, route="flash_prefill", q_offset=0, kv_len=Sh,
        causal=True, iters=20, window=w)
    del q, k, v, out
    torch.cuda.empty_cache()
    ring_k, ring_v = rand((Bh, w, KVh, hdh)), rand((Bh, w, KVh, hdh))
    q = rand((Bh, 1, Hh, hdh))
    res["hymba_ring_decode"] = _timed_call(
        torch, errs, "hymba ring decode", q, ring_k, ring_v,
        route="flash_decode", causal=False, q_offset=0, kv_len=w)
    del ring_k, ring_v, q
    cfg = _serve_cfg(SERVE_WHISPER)
    Bw, F = SERVE_WHISPER["batch"], cfg.n_audio_frames
    P, n_new = SERVE_WHISPER["prompt_len"], SERVE_WHISPER["new_tokens"]
    Hw, KVw, hdw = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (rand((Bw, F, Hw, hdw)), rand((Bw, F, KVw, hdw)),
               rand((Bw, F, KVw, hdw)))
    res["whisper_encoder"] = _timed_call(
        torch, errs, "whisper encoder", q, k, v, route="flash_prefill",
        causal=False, q_offset=0, kv_len=F, iters=20)
    for tag, Sq in (("prompt", P), ("decode", 1)):
        res[f"whisper_cross_{tag}"] = _timed_call(
            torch, errs, f"whisper cross {tag}", rand((Bw, Sq, Hw, hdw)),
            k, v, route="flash_decode", causal=False, q_offset=0, kv_len=F)
    del q, k, v
    kc, vc = (rand((Bw, P + n_new, KVw, hdw)) for _ in range(2))
    pos = P + n_new // 2
    res["whisper_self_decode"] = _timed_call(
        torch, errs, "whisper self decode", rand((Bw, 1, Hw, hdw)), kc, vc,
        route="flash_decode", causal=True, q_offset=pos, kv_len=pos + 1)
    del kc, vc
    torch.cuda.empty_cache()

    # phi3.5-moe (32/8 heads, 4 a kv head) and arctic-480b (56/8, 7 a kv
    # head), hd 128: the bf16 prefill on flash_prefill and a mid-decode
    # step (kv_len 2081) on flash_decode, with its split count
    for tag, spec in (("phi35moe", SERVE_PHI35MOE), ("arctic", SERVE_ARCTIC)):
        Bm, Sm, Hm, KVm, hdm = _attn_shape(spec)
        q, k, v = (rand((Bm, Sm, Hm, hdm)), rand((Bm, Sm, KVm, hdm)),
                   rand((Bm, Sm, KVm, hdm)))
        res[f"{tag}_prefill"] = _timed_call(
            torch, errs, f"{tag} prefill", q, k, v, route="flash_prefill",
            causal=True, q_offset=0, kv_len=Sm, iters=20)
        del q, k, v
        n_new = spec["new_tokens"]
        kc, vc = (rand((Bm, Sm + n_new, KVm, hdm)) for _ in range(2))
        pos = Sm + n_new // 2
        res[f"{tag}_decode"] = _timed_call(
            torch, errs, f"{tag} decode", rand((Bm, 1, Hm, hdm)), kc, vc,
            route="flash_decode", causal=True, q_offset=pos, kv_len=pos + 1)
        res[f"{tag}_decode"]["decode_splits"] = fkernel.decode_splits(
            pos + 1, Bm * KVm, sms)
        del kc, vc
        torch.cuda.empty_cache()

    Bw, Sw, Hw, hdw = _rwkv6_wkv_shape()
    x = _wkv_inputs(torch, gen, dev, Bw, Sw, Hw, hdw)
    out = wops.wkv(*x)
    for g, w, part in zip(out, wref.wkv_ref(*x), ("out", "state")):
        errs["wkv"] = max(errs["wkv"], _compare(
            torch, g, w, f"timed prefill {part}", WKV_TOL))
    res["wkv"] = _wkv_timing(torch, x, None, iters=10)
    x1 = _wkv_inputs(torch, gen, dev, Bw, 1, Hw, hdw)
    state0 = out[1]
    res["wkv_decode"] = _wkv_timing(torch, x1, state0, iters=50)
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
    emit({"phase": "serve_timing", **res,
          "device_ms_from_events": list(DEVICE_MS_FROM_EVENTS)})
    return {k: {f: v[f] for f in LINE_FIELDS}
            for k, v in res.items() if k in KERNELS}


if __name__ == "__main__":
    sys.exit(main())
