#!/usr/bin/env python3
"""chip_smoke.py's two GSPMD-step phases alone, on one card, and the probe
that sized the second.

    python3 tools/gspmd_phases.py [--probe B:S ...] [--no-phases]

Runs `phase_train_gspmd_minicpm` (minicpm-2b at full width and depth,
remat="full", 4 microbatches of 2 x 4096 tokens, 3 steps) and
`phase_train_gspmd_remat` (qwen3-1.7b: remat none / full / dots at
GSPMD_REMAT's batch and sequence, then 16 x 4096 as 8 microbatches),
printing their JSON lines and seconds. No kernel is on these paths, so
nothing is built.

--probe B:S ... first runs one step of qwen3-1.7b at full width and depth
(one microbatch) at each (batch, sequence) with each remat, from the same
init, and prints its peak GiB and seconds, or "oom" where the card's
memory ran out, a JSON line each: the largest point at which
remat="none" fits is GSPMD_REMAT's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def probe(torch, cs, dev, points) -> None:
    from repro_torch.configs import get_config
    cfg = get_config(cs.GSPMD_REMAT["arch"])
    for batch, seq_len in points:
        batches = cs._gspmd_batches(torch, dev, cfg, batch, seq_len, 1,
                                    cs.GSPMD_SEED)
        for remat in ("none", "full", "dots"):
            rec = {"arch": cfg.name, "batch": batch, "seq_len": seq_len,
                   "remat": remat}
            try:
                state, (step,) = cs._gspmd_steps(
                    torch, dev, cfg.replace(remat=remat), batches, 1,
                    cs.GSPMD_REMAT["lr"])
                rec.update({k: step[k] for k in ("peak_gib", "seconds",
                                                 "loss", "mfu")})
                del state
            except torch.cuda.OutOfMemoryError:
                rec["oom"] = True
            torch.cuda.empty_cache()
            rec["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
            print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", nargs="*", default=[], metavar="B:S")
    ap.add_argument("--no-phases", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("gspmd_phases: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    points = [tuple(int(x) for x in p.split(":")) for p in args.probe]
    if points:
        t = time.perf_counter()
        probe(torch, cs, dev, points)
        print(f"probe {time.perf_counter() - t:.2f} s", flush=True)
    if args.no_phases:
        return 0
    for name, run in (("train_gspmd_minicpm", cs.phase_train_gspmd_minicpm),
                      ("train_gspmd_remat", cs.phase_train_gspmd_remat)):
        t = time.perf_counter()
        launches = run(torch, dev)
        print(f"{name} {time.perf_counter() - t:.2f} s, launches "
              f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
