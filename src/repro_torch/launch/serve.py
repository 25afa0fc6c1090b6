"""Serve a model: prefill a batch of prompts, greedy-decode new tokens (the
port's counterpart of `examples/serve_decode.py`).

Random parameters from `--seed` (a torch generator on the run's device) and
random prompt tokens from the same seed (a CPU generator). Runs on CUDA
unless `--device cpu` is given; on CUDA every attention of qwen3 goes
through the flash-attention kernel and every rwkv6 recurrence through the
wkv kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.train.serve import generate


def main(argv=None):
    """Returns (tokens (B, new_tokens) int64 on the run's device, log): the
    log holds the config, the parameter count, prefill seconds, decode
    seconds per token, tokens/s, peak device memory (None on the CPU) and
    the kernel launches of the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.new_tokens < 1 or args.prompt_len < 1 or args.batch < 1:
        raise ValueError("--batch, --prompt-len and --new-tokens must be >= 1")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(args.seed, device)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    print(f"{cfg.name}: {model.param_count(params) / 1e6:.2f}M params "
          f"({cfg.family}, {cfg.n_layers} layers), vocab={cfg.vocab_size}, "
          f"on {device}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    run: dict = {}
    tokens = generate(model, params, prompt, args.new_tokens, log=run)
    n_new = args.batch * args.new_tokens
    total = run["prefill_seconds"] + run["decode_seconds"]
    steps = args.new_tokens - 1
    log = {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "params": model.param_count(params), "batch": args.batch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
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
