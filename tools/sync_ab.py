#!/usr/bin/env python3
"""The training launcher's sync seconds for two source trees, in turns on
one card.

    mkdir -p build/parent && git archive HEAD src | tar -x -C build/parent
    python3 tools/sync_ab.py --src build/parent/src [--arch ARCH ...]
        [--rounds 3] [--steps 8]

For each arch (default internlm2-1.8b and qwen3-1.7b) and round, runs
`repro_torch.launch.train.main` at full width on 4 members (healthy step
0, degraded steps 1 .. steps-2 around straggler 1, repaired last step) in
a fresh process, from the other tree and this checkout's `src` in turns:
other, this, this, other. Prints one JSON line per run (its steps' sync
kinds and seconds, its peak GiB) and per arch and tree the degraded and
healthy syncs' median and range, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.launch.train import main
torch.cuda.reset_peak_memory_stats()
_, log = main(json.loads(sys.argv[2]))
print("RESULT " + json.dumps({
    "syncs": [[r["sync"], r["sync_seconds"]] for r in log],
    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
"""


def _run(src: str, argv: list) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, src,
                           json.dumps(argv)], capture_output=True, text=True,
                          check=True, timeout=900)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the other tree's src directory")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sides = {"other": str(pathlib.Path(args.src).resolve()),
             "this": str(ROOT / "src")}
    for arch in args.arch or ["internlm2-1.8b", "qwen3-1.7b"]:
        argv = ["--arch", arch, "--dp", "4", "--seq-len", "128",
                "--global-batch", "8", "--steps", str(args.steps),
                "--fail-at", "1", "--repair-at", str(args.steps - 1),
                "--straggler", "1", "--log-every", "100"]
        seen = {"other": [], "this": []}
        for r in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                res = _run(sides[side], argv)
                seen[side].append(res)
                print(json.dumps({"arch": arch, "round": r, "side": side,
                                  **res}), flush=True)
        for side, runs in seen.items():
            out = {"arch": arch, "side": side, "runs": len(runs)}
            for kind in ("optcc", "psum"):
                ms = sorted(s * 1e3 for run in runs for k, s in run["syncs"]
                            if k == kind)
                out[kind + "_ms"] = {"median": statistics.median(ms),
                                     "min": ms[0], "max": ms[-1]}
            out["peak_gib"] = max(run["peak_gib"] for run in runs)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
