"""The benchmark of repro_torch: one run of one cell on the card.

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Builds the cell's program from the seed, warms it up, measures for
--seconds, checks what the timed path produced against the plain
reference and prints, as the last line of standard output, one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and checks (each number compared, with its limit). Earlier
lines carry the card's name and power limit, the peak memory and the
cell's counts. It needs a CUDA card and never falls back to the CPU, and
it refuses to print a result when the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# program builds its own kernels into build/repro_torch/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (repro_torch is not repro)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> dict:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        text = got.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        text = f"nvidia-smi failed: {exc}"
    return {"card": text}


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import spec as spec_mod
    spec = spec_mod.load(args.workload)
    import torch
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{spec.name} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    from bench.harness import cell
    say(card_line())
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), say, T_START)
    say({"peak_gib": result["device"]["memory_peak_bytes"] / 2 ** 30})
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
