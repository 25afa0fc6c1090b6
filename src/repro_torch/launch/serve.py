"""Serve a model: prefill a batch of prompts, greedy-decode new tokens (the
port's counterpart of `examples/serve_decode.py`).

Random parameters from `--seed` (a torch generator on the run's device) and
random prompt tokens from the same seed (a CPU generator). Runs on CUDA
unless `--device cpu` is given; on CUDA every attention of the dense and
vlm decoders (qwen3, internlm2, minicpm, gemma3, qwen2-vl) goes through the
flash-attention kernels (gemma3's local layers with their window in the
prefill and over their rolling caches in decode; qwen2-vl's prompt is text,
its M-RoPE ids equal), hymba's windowed attention (the prefill within its
window, each decode step over its ring; the Mamba scan is plain PyTorch)
and whisper's encoder, cross-attention and decoder, the MoE decoders'
attention (phi3.5-moe, arctic-480b; their experts are plain PyTorch, as in
JAX), and every rwkv6 recurrence through the wkv kernel. gemma3-27b at full
width (54.0 GB of bf16 weights) fits one 80 GB card; the MoE configs at
full depth do not (phi3.5-moe: 83.7 GB of bf16 weights; arctic-480b: 27.2
GB a layer), so they serve at full width with fewer layers:
`--set n_layers=N` overrides a config field, parsed as the JAX dry run's
`--set` (repeatable; an unknown field raises).

whisper takes the stubbed conv output as its audio: `--frames` frames
(default the config's n_audio_frames, 1500 = 30 s) of standard-normal
(B, F, d) embeddings drawn in fp32 from `--seed` after the prompt, and
cast to the compute dtype, the dtype the JAX package's dry run gives them
(`repro/launch/mesh.py`): bf16 at full width, fp32 in the smoke config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
  (likewise --arch internlm2-1.8b, minicpm-2b, qwen2-vl-2b, hymba-1.5b or
  arctic-480b; on the card, e.g. --arch arctic-480b --set n_layers=2)
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, parse_overrides
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models.common import torch_dtype
from repro_torch.train.serve import generate


def main(argv=None):
    """Returns (tokens (B, new_tokens) int64 on the run's device, log): the
    log holds the config, the parameter count, prefill seconds, decode
    seconds per token, tokens/s, peak device memory (None on the CPU) and
    the kernel launches of the run, and the config overrides."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=None,
                    help="whisper: audio frames (default n_audio_frames)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, as the JAX dry run's --set "
                         "(e.g. n_layers=2 to cut depth); repeatable")
    args = ap.parse_args(argv)
    if args.new_tokens < 1 or args.prompt_len < 1 or args.batch < 1:
        raise ValueError("--batch, --prompt-len and --new-tokens must be >= 1")

    device = resolve_device(args.device)
    overrides = parse_overrides(args.set)
    cfg = get_config(args.arch, smoke=args.smoke).replace(**overrides)
    if overrides:
        print(f"config overrides: {overrides}", flush=True)
    model = build_model(cfg)
    params = model.init(args.seed, device)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    extras = None
    if cfg.family == "whisper":
        n_frames = args.frames or cfg.n_audio_frames
        if not 1 <= n_frames <= cfg.n_audio_frames:
            raise ValueError(f"--frames must be in [1, {cfg.n_audio_frames}]")
        frames = torch.randn((args.batch, n_frames, cfg.d_model),
                             generator=gen)
        extras = {"frames": frames.to(device,
                                      torch_dtype(cfg.compute_dtype))}
    print(f"{cfg.name}: {model.param_count(params) / 1e6:.2f}M params "
          f"({cfg.family}, {cfg.n_layers} layers), vocab={cfg.vocab_size}, "
          f"on {device}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    run: dict = {}
    tokens = generate(model, params, prompt, args.new_tokens, extras,
                      log=run)
    n_new = args.batch * args.new_tokens
    total = run["prefill_seconds"] + run["decode_seconds"]
    steps = args.new_tokens - 1
    log = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "overrides": overrides,
        "params": model.param_count(params), "batch": args.batch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "frames": None if extras is None else extras["frames"].shape[1],
        "device": str(device),
        "prefill_seconds": run["prefill_seconds"],
        "decode_seconds": run["decode_seconds"],
        "decode_ms_per_token": (run["decode_seconds"] / steps * 1e3
                                if steps else None),
        "tokens_per_s": n_new / total,
        "logits_finite": run["logits_finite"],
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None),
        "launches": {k: v - before[k] for k, v in launch_counts().items()},
    }
    print(f"prefill {args.prompt_len} x{args.batch} in "
          f"{log['prefill_seconds']:.3f}s; decode {steps} steps at "
          f"{(log['decode_ms_per_token'] or 0.0):.2f} ms/token; "
          f"{log['tokens_per_s']:.1f} new tokens/s", flush=True)
    for b in range(min(args.batch, 2)):
        print(f"  [{b}] {tokens[b].tolist()}", flush=True)
    return tokens, log


if __name__ == "__main__":
    main()
