#!/usr/bin/env python3
"""The probe that sized chip_smoke.py's `train_gspmd_remat` phase, on one
card.

    python3 tools/gspmd_phases.py --probe B:S [B:S ...]

Runs one step of qwen3-1.7b at full width and depth (one microbatch) at
each (batch, sequence) with each remat, from the same init, and prints its
peak GiB and seconds, or "oom" where the card's memory ran out, a JSON line
each: the largest point at which remat="none" fits with room to spare is
GSPMD_REMAT's. The two GSPMD phases themselves run alone with
`python3 chip_smoke.py --phases train_gspmd_minicpm train_gspmd_remat`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
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
    ap.add_argument("--probe", nargs="+", required=True, metavar="B:S")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("gspmd_phases: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs._smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    points = [tuple(int(x) for x in p.split(":")) for p in args.probe]
    t = time.perf_counter()
    probe(torch, cs, torch.device("cuda"), points)
    print(f"probe {time.perf_counter() - t:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
