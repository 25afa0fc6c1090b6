#!/usr/bin/env python3
"""chip_smoke.py's two process-transport phases alone, on one card.

    python3 tools/dist_phases.py [--n-grad N] [--layers L]

Builds the kernels, then runs `phase_dist_collectives` (psum and the
OptCC tree at N elements over four gloo ranks on the card, against the
recomputed sum; every collective at 2^24 + 1 elements on both
transports) and `phase_main_path_dist` (`launch.train --transport gloo`
on qwen3-1.7b at full width and L layers, against the single-process
run), printing their JSON lines and seconds. The defaults are
chip_smoke.py's: qwen3-1.7b's gradient length and DIST_LAYERS. A smaller
N or L gives a quick look at the path before the whole script.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
QWEN3_GRAD = 1_720_574_976      # qwen3-1.7b's parameter count


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-grad", type=int, default=QWEN3_GRAD)
    ap.add_argument("--layers", type=int, default=None,
                    help="qwen3-1.7b layers of main_path_dist (default: "
                         "chip_smoke.DIST_LAYERS)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch import _build
    if not torch.cuda.is_available():
        print("dist_phases: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.layers is not None:
        cs.DIST_ARGV = [a if not a.startswith("n_layers=")
                        else f"n_layers={args.layers}" for a in cs.DIST_ARGV]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t:.2f} s", flush=True)
    for name, run in (("dist_collectives",
                       lambda: cs.phase_dist_collectives(torch, dev,
                                                         args.n_grad)),
                      ("main_path_dist",
                       lambda: cs.phase_main_path_dist(torch, dev))):
        t = time.perf_counter()
        launches = run()
        print(f"{name} {time.perf_counter() - t:.2f} s, launches "
              f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
