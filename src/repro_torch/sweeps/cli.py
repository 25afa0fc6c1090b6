"""`python -m repro_torch.sweeps`: run fault-scenario sweeps, write/check artifacts.

Usage:
  python -m repro_torch.sweeps --smoke                      # CI-sized, seconds
  python -m repro_torch.sweeps --full --workers 8           # nightly-sized
  python -m repro_torch.sweeps --smoke --deterministic      # byte-stable artifact
  python -m repro_torch.sweeps --smoke --telemetry          # + per-stage breakdowns
  python -m repro_torch.sweeps --trace smoke_p8_single_e1_75 --trace-out trace.json
  python -m repro_torch.sweeps --trace worst --trace-from BENCH_sweep.json
  python -m repro_torch.sweeps check BENCH_sweep.json --thresholds ci/sweep_thresholds.json
  python -m repro_torch.sweeps summary BENCH_sweep.json --out "$GITHUB_STEP_SUMMARY"
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.sweeps import artifact as art
from repro_torch.sweeps.engine import grid_for, run_sweep, sanity_check


def _add_run_args(ap: argparse.ArgumentParser) -> None:
    prof = ap.add_mutually_exclusive_group()
    prof.add_argument("--smoke", dest="profile", action="store_const",
                      const="smoke", help="CI-sized grid (seconds on CPU)")
    prof.add_argument("--full", dest="profile", action="store_const",
                      const="full", help="nightly-sized grid (minutes)")
    prof.add_argument("--profile", dest="profile",
                      help="explicit grid name (smoke|full)")
    ap.set_defaults(profile="smoke")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the randomized tail of the grid")
    ap.add_argument("--workers", type=int,
                    default=min(os.cpu_count() or 1, 8),
                    help="worker processes (0 = serial)")
    ap.add_argument("--out", default="BENCH_sweep.json",
                    help="artifact path")
    ap.add_argument("--deterministic", action="store_true",
                    help="zero wall-clock fields so the artifact is a pure "
                         "function of the grid (byte-identical across runs)")
    ap.add_argument("--thresholds", default=None,
                    help="optionally gate the fresh artifact against a "
                         "thresholds JSON after the run")
    ap.add_argument("--telemetry", action="store_true",
                    help="attribute each scenario's simulated time to OptCC "
                         "stages along the critical path (adds "
                         "stage_breakdown + per-stage summaries to the "
                         "artifact; timings are bit-identical either way)")
    ap.add_argument("--trace", metavar="SCENARIO", default=None,
                    help="instead of sweeping, simulate one named scenario "
                         "with telemetry and write a Chrome trace "
                         "(chrome://tracing / Perfetto). 'worst' picks the "
                         "highest-overhead scenario from --trace-from")
    ap.add_argument("--trace-out", default="trace.json",
                    help="Chrome-trace output path (with --trace)")
    ap.add_argument("--trace-from", metavar="ARTIFACT", default=None,
                    help="artifact to resolve --trace worst against")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweeps",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd")
    _add_run_args(ap)
    chk = sub.add_parser("check", help="validate + threshold-gate an "
                                       "existing artifact")
    chk.add_argument("artifact", help="path to BENCH_sweep.json")
    # SUPPRESS: don't let this subparser's default clobber a --thresholds
    # given before the `check` word (argparse parent/subparser collision).
    chk.add_argument("--thresholds", default=argparse.SUPPRESS,
                     help="thresholds JSON to gate against")
    summ = sub.add_parser("summary", help="render an artifact's summary as "
                                          "a Markdown table (for "
                                          "$GITHUB_STEP_SUMMARY)")
    summ.add_argument("artifact", help="path to BENCH_sweep.json")
    summ.add_argument("--out", default="-",
                      help="write/append the Markdown here ('-' = stdout; "
                           "an existing file is appended to, matching "
                           "$GITHUB_STEP_SUMMARY semantics)")
    return ap


def _gate(artifact_obj: dict, thresholds_path: str | None) -> int:
    errs = art.validate_artifact(artifact_obj)
    for e in errs:
        print(f"SCHEMA FAIL: {e}", file=sys.stderr)
    if errs:
        return 1
    print(f"schema OK: {artifact_obj['scenario_count']} scenarios "
          f"({artifact_obj['schema']})")
    if thresholds_path is None:
        return 0
    with open(thresholds_path) as f:
        thresholds = json.load(f)
    fails = art.check_thresholds(artifact_obj, thresholds)
    for msg in fails:
        print(f"REGRESSION: {msg}", file=sys.stderr)
    if fails:
        return 1
    print(f"thresholds OK ({thresholds_path})")
    return 0


def measure_schedgen_latency(p: int = 1024, k: int = 4,
                             trials: int = 7) -> float:
    """Worst best-of-N wall time (ms) of the descriptor-only re-planning
    path at the paper's p=1024 scale - the '< 1 ms' claim of Section 4.3,
    gated by schedgen_latency_ms_max in the thresholds file. Best-of (not
    mean) per algorithm because the claim is about the algorithm, not
    scheduler noise; worst-of across every registered algorithm the probe
    profiles support (auto/ring/optcc plus each topology's closed-form time
    model and per-topology bound - hierarchical via a multi-GPU profile) so
    the single gate value bounds re-planning latency whichever algorithm
    the runtime asks for."""
    from repro_torch.core import registry
    from repro_torch.core.model import BandwidthProfile
    from repro_torch.core.planner import make_plan
    n = (p - 1) * k * 16
    profiles = [BandwidthProfile.single_straggler(p, 1.5),
                BandwidthProfile.single_straggler(p, 1.5, g=8)]
    worst = 0.0
    for prof in profiles:
        for algo in ("auto",) + registry.supported(prof):
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                make_plan(prof, n=n, k=k, materialize=False, algo=algo)
                best = min(best, time.perf_counter() - t0)
            worst = max(worst, best)
    return worst * 1e3


def worst_scenario_name(artifact_obj: dict) -> str:
    """Name of the scenario with the highest OptCC overhead - the one worth
    staring at in a trace viewer."""
    recs = artifact_obj["scenarios"]
    if not recs:
        raise ValueError("artifact has no scenarios")
    return max(recs, key=lambda r: (r["overhead_optcc"], r["name"]))["name"]


def cmd_trace(args: argparse.Namespace) -> int:
    """Simulate one scenario with telemetry and write a Chrome trace."""
    from repro_torch import obs
    from repro_torch.core.planner import make_plan
    from repro_torch.core.simulator import simulate
    name = args.trace
    if name == "worst":
        if args.trace_from is None:
            print("error: --trace worst needs --trace-from ARTIFACT",
                  file=sys.stderr)
            return 2
        name = worst_scenario_name(art.load_artifact(args.trace_from))
        print(f"worst-overhead scenario: {name}", file=sys.stderr)
    specs = [s for s in grid_for(args.profile, seed=args.seed)
             if s.name == name]
    if not specs:
        print(f"error: scenario {name!r} not in the "
              f"{args.profile!r} grid", file=sys.stderr)
        return 2
    spec = specs[0]
    plan = make_plan(spec.profile(), spec.n, k=spec.k,
                     fill_bubbles=spec.fill_bubbles, materialize="arrays")
    res = simulate(plan.schedule, telemetry=True)
    obs.write_chrome_trace(res.telemetry, args.trace_out, name=spec.name)
    breakdown = obs.stage_breakdown(res.telemetry)
    print(f"wrote {args.trace_out}: {spec.name} algo={plan.algo} "
          f"T={res.makespan:.6g} ({res.telemetry.nflows} flows)")
    for stage, v in sorted(breakdown.items(), key=lambda kv: -kv[1]):
        print(f"  {stage:10s} {v:14.3f}  ({v / res.makespan:6.1%})")
    return 0


def _fmt_ms(x) -> str:
    return "-" if x is None else f"{x:.3f}ms"


def cmd_run(args: argparse.Namespace) -> int:
    t_start = time.perf_counter()
    specs = grid_for(args.profile, seed=args.seed)
    print(f"sweep profile={args.profile} seed={args.seed}: "
          f"{len(specs)} scenarios, workers={args.workers}"
          f"{' +telemetry' if args.telemetry else ''}", file=sys.stderr)
    run_stats: dict = {}
    results = run_sweep(specs, workers=args.workers,
                        measure_latency=not args.deterministic,
                        telemetry=args.telemetry, stats=run_stats)
    if run_stats.get("retries"):
        print(f"worker fan-out: {run_stats['retries']} chunk retr"
              f"{'y' if run_stats['retries'] == 1 else 'ies'} after "
              f"crash/hang", file=sys.stderr)
    bad = sanity_check(results)
    for msg in bad:
        print(f"INVARIANT FAIL: {msg}", file=sys.stderr)
    schedgen_ms = None if args.deterministic else measure_schedgen_latency()
    artifact_obj = art.build_artifact(results, profile=args.profile,
                                      seed=args.seed,
                                      deterministic=args.deterministic,
                                      schedgen_latency_ms=schedgen_ms,
                                      telemetry=args.telemetry,
                                      retries=run_stats.get("retries", 0))
    art.write_artifact(artifact_obj, args.out)
    wall = time.perf_counter() - t_start
    overall = artifact_obj["summary"]["overall"]
    print(f"wrote {args.out}: {len(results)} scenarios in {wall:.1f}s | "
          f"overhead p50={overall['overhead_optcc_p50']:.4f} "
          f"p99={overall['overhead_optcc_p99']:.4f} "
          f"max={overall['overhead_optcc_max']:.4f} | "
          f"vs-LB p99={overall['optcc_vs_lb_p99']:.4f} | "
          f"gen p99={_fmt_ms(overall['gen_ms_p99'])} | "
          f"schedgen(p=1024)={_fmt_ms(schedgen_ms)}")
    if args.telemetry:
        for stage, st in sorted(overall["stages"].items()):
            print(f"  stage {stage:10s} n={st['count']:4d} "
                  f"overhead p50={st['overhead_p50']:.4f} "
                  f"p99={st['overhead_p99']:.4f} "
                  f"max={st['overhead_max']:.4f}")
    if bad:
        return 1
    return _gate(artifact_obj, args.thresholds)


def cmd_check(args: argparse.Namespace) -> int:
    return _gate(art.load_artifact(args.artifact), args.thresholds)


def _md(x, fmt: str = "{:.4f}") -> str:
    return "–" if x is None else fmt.format(x)


def format_markdown_summary(artifact_obj: dict) -> str:
    """Render the artifact's summary block as GitHub-flavored Markdown:
    overall + per-family overhead percentiles (replay families additionally
    show the no-replan baseline's percentiles) and, on telemetry artifacts,
    the per-stage critical-path table."""
    summary = artifact_obj["summary"]
    out = [f"### Sweep summary — `{artifact_obj['profile']}` grid, "
           f"{artifact_obj['scenario_count']} scenarios "
           f"(`{artifact_obj['schema']}`)", ""]
    out.append("| group | count | overhead p50 | overhead p99 | "
               "overhead max | vs-LB p99 | no-replan p99 | vs-oracle p99 | "
               "vs-auto p99 | gen ms p99 |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    groups = [("**overall**", summary["overall"])]
    groups += sorted(summary.get("by_family", {}).items())
    # Detection records again, grouped by controller policy - the rows that
    # show what debounce/backoff buy over reacting to every probe.
    groups += [(f"policy:{pol}", st)
               for pol, st in sorted(summary.get("by_policy", {}).items())]
    # Topology records again, grouped by requested algorithm - the per-algo
    # overhead rows (vs its own lower bound, and vs the planner's auto pick).
    groups += [(f"algo:{algo}", st)
               for algo, st in sorted(summary.get("by_algo", {}).items())]
    for name, st in groups:
        out.append(
            f"| {name} | {st['count']} | {_md(st['overhead_optcc_p50'])} | "
            f"{_md(st['overhead_optcc_p99'])} | "
            f"{_md(st['overhead_optcc_max'])} | "
            f"{_md(st['optcc_vs_lb_p99'])} | "
            f"{_md(st.get('overhead_noreplan_p99'))} | "
            f"{_md(st.get('overhead_vs_oracle_p99'))} | "
            f"{_md(st.get('overhead_vs_auto_p99'))} | "
            f"{_md(st['gen_ms_p99'], '{:.3f}')} |")
    stages = summary["overall"].get("stages")
    if stages:
        out += ["", "#### Critical-path stages (overall)", ""]
        out.append("| stage | count | overhead p50 | overhead p99 | "
                   "overhead max |")
        out.append("|---|---|---|---|---|")
        for stage, st in sorted(stages.items()):
            out.append(f"| {stage} | {st['count']} | "
                       f"{_md(st['overhead_p50'])} | "
                       f"{_md(st['overhead_p99'])} | "
                       f"{_md(st['overhead_max'])} |")
    lat = artifact_obj.get("schedgen_latency_ms")
    out += ["", f"schedule-gen latency (p=1024, best-of-N): "
                f"{_md(lat, '{:.3f}')} ms", ""]
    return "\n".join(out)


def cmd_summary(args: argparse.Namespace) -> int:
    md = format_markdown_summary(art.load_artifact(args.artifact))
    if args.out == "-":
        print(md)
    else:
        with open(args.out, "a") as f:
            f.write(md + "\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "check":
            return cmd_check(args)
        if args.cmd == "summary":
            return cmd_summary(args)
        if args.trace is not None:
            return cmd_trace(args)
        return cmd_run(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
