"""Readings that the limits of a cell's correctness check are set from.

    python3 bench/calibrate.py --workload CELL --seeds 101 102 ... \
        [--controls 3] [--out FILE]

For each seed, one run of the program's timed path as the benchmark runs
it (set-up, a window of one step or call, the comparison), giving the
program's readings of every compared number. On the first --controls
seeds, also the readings that the traffic's driver gives for its
controls and faults (`calibration` in `harness/drivers/<driver>.py`):
the plain reference put in the program's place at the precision below
the configuration's (training: fp8, and fp8 operands alone; AllReduce:
bf16 accumulation), and for training cells the faults planted in that
reference (half the batch, no exchange between the members, one altered
gradient element). Prints one JSON line per reading, and appends them to
--out.

    python3 bench/calibrate.py --summarize FILE...

reads such lines back and prints, for each cell and number, its lower
reading (the largest the program gave), its upper reading (the least of:
each control's smallest reading where that is 3x the lower or more; for
a training cell each fault's smallest where that is 10x the lower or more,
and 1 for the change of a state left unchanged) and the limit between them,
lower^(1/3) upper^(2/3): more room above the lower than below the upper.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

def calibrate(spec, seeds, controls: int, device, emit,
              sides=("program", "control", "faults")) -> None:
    import torch
    from bench.harness import spec as spec_mod
    drv = spec_mod.driver(spec.traffic["driver"])
    for i, seed in enumerate(seeds):
        ref = None
        if "program" in sides:
            t = time.perf_counter()
            notes = {}
            run = drv.run(spec, seed, 0.0, False, device, notes.update,
                          time.perf_counter())
            emit({"seed": seed, "side": "program",
                  "readings": run["values"], "peak": run["peak"],
                  "notes": notes, "seconds": time.perf_counter() - t})
            ref = run.get("reference")
            del run
        if i < controls:
            t = time.perf_counter()
            for side, readings in drv.calibration(spec, seed, device, sides,
                                                  ref):
                emit({"seed": seed, "side": side, "readings": readings,
                      "seconds": time.perf_counter() - t})
                t = time.perf_counter()
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()


def summarize(lines: list) -> dict:
    """{cell: {number: {lower, upper, upper_from, limit, seeds}}}."""
    cells = {}
    for rec in lines:
        cells.setdefault(rec["workload"], []).append(rec)
    out = {}
    for cell, recs in cells.items():
        out[cell] = {}
        for num in recs[0]["readings"]:
            prog = [r["readings"][num] for r in recs if r["side"] == "program"]
            lower = max(prog)
            least = {}
            for r in recs:
                if r["side"] != "program":
                    side = least.setdefault(r["side"], r["readings"][num])
                    least[r["side"]] = min(side, r["readings"][num])
            cands = [(v, side) for side, v in least.items()
                     if v >= (3 if side.startswith("control") else 10)
                     * lower]
            if num == "param_change" and 1.0 >= 3 * lower:
                cands.append((1.0, "unchanged"))
            entry = {"lower": lower, "seeds": len(prog)}
            if cands:
                upper, side = min(cands)
                entry.update(upper=upper, upper_from=side,
                             limit=lower ** (1 / 3) * upper ** (2 / 3))
            out[cell][num] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--summarize", nargs="+", metavar="FILE")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="+")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--sides", nargs="+", default=["program", "control",
                                                     "faults"],
                    choices=["program", "control", "faults"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.summarize:
        lines = [json.loads(line) for f in args.summarize
                 for line in open(f) if line.strip()]
        print(json.dumps(summarize(lines), indent=1))
        return 0
    import torch
    from bench.harness import spec as spec_mod
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    spec = spec_mod.load(args.workload)

    def emit(obj):
        obj = {"workload": spec.name, **obj}
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    calibrate(spec, args.seeds, args.controls, torch.device("cuda", 0), emit,
              args.sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
