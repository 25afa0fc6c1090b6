#!/usr/bin/env python3
"""Profile the serving steps of one checkout of the port on one CUDA card:
the warm prefill, and decode steps split into host enqueue time and device
kernel time.

    python3 tools/serve_step_profile.py [--arch ARCH] [--src DIR] [--tag NAME]

--src is the `src` directory of the checkout to measure (default: this
one's), so that two commits can be compared on one card in turns, e.g. with
a parent unpacked by `git archive` into the gitignored `build/parent`:

    for s in parent change change parent; do
      python3 tools/serve_step_profile.py --tag $s \\
        --src $([ $s = parent ] && echo build/parent/src || echo src); done

Full width at `chip_smoke.py`'s serve shapes (qwen3-1.7b, the default:
batch 8, prompt 2048, 64 new tokens; gemma3-27b: batch 4, prompt 2048, 32
new tokens; phi3.5-moe-42b-a6.6b and arctic-480b: batch 8, prompt 2048,
64 new, at chip_smoke's cut depths of 24 and 2 layers, the rest at full
depth), random weights from seed 0. The prefill is run twice and the
second is timed (synchronized), then a third under torch.profiler. Then 5
decode steps warm up, 15 are timed one by one (host clock; the step's
host enqueue time, then its wall time to a synchronize after the greedy
argmax), and 5 more run under torch.profiler for the device time of each
kernel. One JSON line: medians in ms, the device time of all kernels per
step and of the prefill in ms, and the 8 largest device times and 12
largest host self times per step (and the prefill's 8 largest device
times) in us.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"qwen3-1.7b": (8, 2048, 64), "gemma3-27b": (4, 2048, 32),
          "phi3.5-moe-42b-a6.6b": (8, 2048, 64), "arctic-480b": (8, 2048, 64)}
# layers kept where full depth does not fit one 80 GB card (chip_smoke.py)
DEPTH = {"phi3.5-moe-42b-a6.6b": 24, "arctic-480b": 2}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(SHAPES))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.serve import pad_cache_to

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = get_config(args.arch)
    if args.arch in DEPTH:
        cfg = cfg.replace(n_layers=DEPTH[args.arch])
    model = build_model(cfg)
    params = model.init(0, "cuda")
    B, S, n_new = SHAPES[args.arch]
    toks = torch.randint(0, cfg.vocab_size, (B, S + n_new),
                         generator=torch.Generator().manual_seed(0)).cuda()
    state = {"pos": S}

    def step():
        pos = state["pos"]
        logits, state["cache"] = model.decode_step(
            params, state["cache"], toks[:, pos:pos + 1], pos)
        state["pos"] = pos + 1
        return logits

    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, cache = model.prefill(params, {"tokens": toks[:, :S]})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
        del cache
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as pprof:
            _, cache = model.prefill(params, {"tokens": toks[:, :S]})
            torch.cuda.synchronize()
        state["cache"] = pad_cache_to(cache, S + n_new)
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        walls, hosts = [], []
        for _ in range(15):
            t = time.perf_counter()
            logits = step()
            hosts.append(time.perf_counter() - t)
            logits.argmax(-1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step().argmax(-1)
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_us = sum(e.device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    dev = sorted(((e.key, e.device_time_total / 5) for e in events
                  if e.device_time_total > 0), key=lambda x: -x[1])
    cpu = sorted(((e.key, e.self_cpu_time_total / 5) for e in events
                  if e.self_cpu_time_total > 0), key=lambda x: -x[1])

    pevents = pprof.key_averages()
    prefill_dev = sorted(((e.key, e.device_time_total) for e in pevents
                          if e.device_time_total > 0), key=lambda x: -x[1])

    def median(x):
        return sorted(x)[len(x) // 2]

    print(json.dumps({
        "tag": args.tag, "arch": cfg.name,
        "device": torch.cuda.get_device_name(0),
        "n_layers": cfg.n_layers, "prefill_s_warm": prefill_s,
        "prefill_device_ms": sum(
            e.device_time_total for e in pevents
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3,
        "top_prefill_device_us": [(k[:60], round(d, 1))
                                  for k, d in prefill_dev[:8]],
        "step_wall_ms_median": median(walls) * 1e3,
        "step_host_enqueue_ms_median": median(hosts) * 1e3,
        "step_device_ms": kernels_us / 5 / 1e3,
        "top_device_us_per_step": [(k[:60], round(d, 1)) for k, d in dev[:8]],
        "top_host_self_us_per_step": [(k[:50], round(c, 1))
                                      for k, c in cpu[:12]]}), flush=True)


if __name__ == "__main__":
    main()
