"""Versioned JSON perf artifact (BENCH_sweep.json) + schema/threshold checks.

The artifact is the sweep's single output: per-scenario overheads plus
p50/p99 summaries, written with canonical serialization (sorted keys, fixed
separators) so that two runs of the same grid with `measure_latency=False`
are byte-identical - CI diffs artifacts, and regression gating reads the
summary block against a checked-in thresholds file.

Schema versioning: bump SCHEMA when a field changes meaning or disappears;
adding fields is backward-compatible (validators only check what they know).
`load_artifact` migrates v1 artifacts in place (see _migrate_v1), so readers
only ever see the current schema.

optcc-sweep/2 (vs /1):
  * top-level ``telemetry`` bool; when true every scenario carries a
    ``stage_breakdown`` ({stage: element-time} summing to t_optcc) and each
    summary group a ``stages`` block with per-stage overhead percentiles;
  * wall-clock fields (``gen_ms``/``sim_ms``, summary ``gen_ms_p50/p99``)
    are null on deterministic runs instead of 0.0 - unmeasured is not zero,
    and the old 0.0 silently satisfied every latency threshold.

optcc-sweep/3 (vs /2):
  * replay-family scenarios (time-varying failure timelines) carry
    ``events`` ([t, rank, ell] triples, t in units of T0), ``t_noreplan`` /
    ``overhead_noreplan`` (the initial plan ridden through the whole
    timeline - the baseline re-planning is scored against) and ``replans``
    (splices made). For these rows t_optcc is the makespan the mid-flight
    re-planning controller *adopts* (min of the replanned chain and the
    no-replan run), so overhead_optcc / optcc_vs_lb score the system's
    actual behavior; the stage_breakdown attributes the no-replan run and
    sums to t_noreplan for replay rows;
  * summary groups containing replay scenarios add
    ``overhead_noreplan_p50/p99/max``;
  * thresholds gain a ``families`` block ({family: {metric_max: limit,
    min_scenarios: N}}); a gated family missing from the artifact fails
    loudly (a grid regression must not silently pass).

optcc-sweep/4 (vs /3):
  * detection-family scenarios (imperfect detector + controller policy over
    a replay timeline) carry every replay field plus ``policy``,
    ``detection`` (the detector/controller parameters, times in T0 units),
    ``t_oracle`` / ``overhead_vs_oracle`` (the same timeline under the PR-8
    zero-delay perfect-knowledge controller - the denominator that prices
    detection imperfection), ``false_replans``, ``suppressed``,
    ``detect_lag_mean`` / ``detect_lag_max`` (null when nothing was
    detected) and ``detect_missed``;
  * summary groups containing detection scenarios add
    ``overhead_vs_oracle_p50/p99/max`` and ``false_replans_total``, and the
    summary block gains ``by_policy`` (detection records grouped by
    controller policy);
  * top-level ``retries`` records how many worker chunks the sweep engine
    had to re-run after a crash/hang (null = unknown, from older artifacts).

optcc-sweep/5 (vs /4):
  * topology-family scenarios (an explicitly requested registry algorithm,
    `ScenarioSpec.algo != "auto"`) carry ``requested_algo``, ``t_auto``
    (the makespan `make_plan(algo="auto")` achieves on the identical
    profile) and ``overhead_vs_auto`` (= t_optcc / t_auto). For these rows
    t_optcc is the requested topology's simulated makespan and lower_bound
    its *per-topology* bound from the registry, so optcc_vs_lb scores the
    topology against its own floor;
  * ``summary.overall`` covers only planner-driven rows (no
    ``requested_algo``): topology rows are deliberately suboptimal
    baselines on profiles the planner would route elsewhere (a double
    binary tree is ~log p slower than T0 by design), and folding them into
    the overall percentiles would force loosening the tight regression
    gates that protect the auto path. Topology rows are summarized in
    ``summary.by_family.topology`` (gated via ``families.topology``) and
    the new ``summary.by_algo`` block (topology records grouped by
    requested algorithm, each adding ``overhead_vs_auto_p50/p99/max``).
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

from repro_torch.sweeps.engine import ScenarioResult
from repro_torch.sweeps.stats import percentile, percentile_or_none

__all__ = ["SCHEMA", "THRESHOLDS_SCHEMA", "percentile", "scenario_record",
           "build_artifact", "canonical_bytes", "write_artifact",
           "load_artifact", "validate_artifact", "check_thresholds"]

SCHEMA = "optcc-sweep/5"
THRESHOLDS_SCHEMA = "optcc-sweep-thresholds/1"

_SCENARIO_REQUIRED = {
    "name": str, "family": str, "algo": str,
    "p": int, "k": int, "n": int, "gpus_per_server": int,
    "num_flows": int,
    "stragglers": list, "ells": list,
    "t0": float, "lower_bound": float, "t_optcc": float,
    "t_predicted": float,
    "overhead_optcc": float, "overhead_lb": float, "optcc_vs_lb": float,
}
# Wall-clock fields: numeric when measured, null on deterministic runs.
_SCENARIO_LATENCY = ("gen_ms", "sim_ms")

_SUMMARY_KEYS = ("count", "overhead_optcc_p50", "overhead_optcc_p99",
                 "overhead_optcc_max", "optcc_vs_lb_p50", "optcc_vs_lb_p99",
                 "optcc_vs_lb_max", "gen_ms_p50", "gen_ms_p99")


def _round(x: Optional[float], digits: int = 9) -> Optional[float]:
    # Fixed rounding keeps artifact bytes stable against float noise from
    # e.g. different summation orders in future parallel scoring.
    return None if x is None else round(float(x), digits)


def scenario_record(r: ScenarioResult, deterministic: bool = False) -> dict:
    s = r.spec
    rec = {
        "name": s.name,
        "family": s.family,
        "algo": r.algo,
        "p": s.p,
        "k": s.k,
        "n": s.n,
        "gpus_per_server": s.gpus_per_server,
        "nvlink_mult": s.nvlink_mult,
        "num_flows": r.num_flows,
        "stragglers": list(s.stragglers),
        "ells": [_round(s.slowdown[i]) for i in s.stragglers],
        "t0": _round(r.t0),
        "lower_bound": _round(r.lower_bound),
        "t_optcc": _round(r.t_optcc),
        "t_ring": _round(r.t_ring),
        "t_predicted": _round(r.t_predicted),
        "overhead_optcc": _round(r.overhead_optcc),
        "overhead_ring": _round(r.overhead_ring),
        "overhead_lb": _round(r.overhead_lb),
        "optcc_vs_lb": _round(r.optcc_vs_lb),
        # Unmeasured is null, not 0.0 (deterministic runs exclude wall
        # clock so artifacts are byte-identical; see schedgen_latency_ms).
        "gen_ms": None if deterministic else _round(r.gen_seconds * 1e3, 6),
        "sim_ms": None if deterministic else _round(r.sim_seconds * 1e3, 6),
    }
    if r.t_auto is not None:
        # Topology family: t_optcc above is the *requested* algorithm's
        # makespan and lower_bound its per-topology floor; t_auto is what
        # the planner's auto policy achieves on the identical profile.
        rec["requested_algo"] = r.requested_algo
        rec["t_auto"] = _round(r.t_auto)
        rec["overhead_vs_auto"] = _round(r.overhead_vs_auto)
    if r.t_noreplan is not None:
        # Replay family: t_optcc above is the re-planning controller's
        # adopted makespan; these are the no-replan baseline (the initial
        # plan ridden through the whole timeline) plus the timeline itself.
        rec["t_noreplan"] = _round(r.t_noreplan)
        rec["overhead_noreplan"] = _round(r.overhead_noreplan)
        rec["replans"] = r.replans
        rec["events"] = [[_round(t), rank, _round(ell)]
                         for t, rank, ell in s.events]
    if r.policy is not None:
        # Detection family: the replay fields above scored the *imperfect*
        # controller; these add the lens parameters and the oracle yardstick.
        rec["policy"] = r.policy
        rec["detection"] = {key: (_round(v) if isinstance(v, float) else v)
                            for key, v in s.detection}
        rec["t_oracle"] = _round(r.t_oracle)
        rec["overhead_vs_oracle"] = _round(r.overhead_vs_oracle)
        rec["false_replans"] = r.false_replans
        rec["suppressed"] = r.suppressed
        rec["detect_lag_mean"] = _round(r.detect_lag_mean)
        rec["detect_lag_max"] = _round(r.detect_lag_max)
        rec["detect_missed"] = r.detect_missed
    if r.stage_breakdown is not None:
        rec["stage_breakdown"] = {st: _round(v)
                                  for st, v in sorted(r.stage_breakdown.items())}
    return rec


def _stage_summary(records: Sequence[dict]) -> dict:
    """Per-stage critical-path overhead percentiles over the scenarios in
    which the stage appears (overhead = contribution / t0). `count` says how
    many scenarios that was - stages are not zero-filled across the grid."""
    per_stage: dict[str, list[float]] = {}
    for r in records:
        t0 = r["t0"]
        for st, v in (r.get("stage_breakdown") or {}).items():
            per_stage.setdefault(st, []).append(v / t0)
    return {st: {"count": len(vs),
                 "overhead_p50": _round(percentile(vs, 50)),
                 "overhead_p99": _round(percentile(vs, 99)),
                 "overhead_max": _round(max(vs))}
            for st, vs in sorted(per_stage.items())}


def _summarize(records: Sequence[dict], telemetry: bool = False) -> dict:
    ov = [r["overhead_optcc"] for r in records]
    vs = [r["optcc_vs_lb"] for r in records]
    gen = [r["gen_ms"] for r in records]
    out = {
        "count": len(records),
        "overhead_optcc_p50": _round(percentile(ov, 50)),
        "overhead_optcc_p99": _round(percentile(ov, 99)),
        "overhead_optcc_max": _round(max(ov)),
        "optcc_vs_lb_p50": _round(percentile(vs, 50)),
        "optcc_vs_lb_p99": _round(percentile(vs, 99)),
        "optcc_vs_lb_max": _round(max(vs)),
        "gen_ms_p50": _round(percentile_or_none(gen, 50), 6),
        "gen_ms_p99": _round(percentile_or_none(gen, 99), 6),
    }
    rep = [r["overhead_noreplan"] for r in records
           if "overhead_noreplan" in r]
    if rep:
        out["overhead_noreplan_p50"] = _round(percentile(rep, 50))
        out["overhead_noreplan_p99"] = _round(percentile(rep, 99))
        out["overhead_noreplan_max"] = _round(max(rep))
    aut = [r["overhead_vs_auto"] for r in records
           if "overhead_vs_auto" in r]
    if aut:
        out["overhead_vs_auto_p50"] = _round(percentile(aut, 50))
        out["overhead_vs_auto_p99"] = _round(percentile(aut, 99))
        out["overhead_vs_auto_max"] = _round(max(aut))
    orc = [r["overhead_vs_oracle"] for r in records
           if "overhead_vs_oracle" in r]
    if orc:
        out["overhead_vs_oracle_p50"] = _round(percentile(orc, 50))
        out["overhead_vs_oracle_p99"] = _round(percentile(orc, 99))
        out["overhead_vs_oracle_max"] = _round(max(orc))
        out["false_replans_total"] = sum(r["false_replans"] for r in records
                                         if "false_replans" in r)
    if telemetry:
        out["stages"] = _stage_summary(records)
    return out


def build_artifact(results: Sequence[ScenarioResult], profile: str,
                   seed: int, deterministic: bool,
                   schedgen_latency_ms: Optional[float] = None,
                   telemetry: bool = False,
                   retries: int = 0) -> dict:
    records = [scenario_record(r, deterministic=deterministic)
               for r in results]
    families = sorted({r["family"] for r in records})
    policies = sorted({r["policy"] for r in records if "policy" in r})
    algos = sorted({r["requested_algo"] for r in records
                    if "requested_algo" in r})
    # "overall" scores the planner-driven path only: topology rows request
    # a specific algorithm regardless of fit (dbtree on a straggler profile
    # is a deliberate baseline) and carry their own gates via
    # families.topology / by_algo; mixing them in would blunt the tight
    # overall regression thresholds. Degenerate topology-only grids keep a
    # non-empty overall block by falling back to all records.
    auto_records = [r for r in records if "requested_algo" not in r]
    summary = {
        "overall": _summarize(auto_records or records, telemetry),
        "by_family": {
            fam: _summarize([r for r in records if r["family"] == fam],
                            telemetry)
            for fam in families
        },
    }
    if policies:
        summary["by_policy"] = {
            pol: _summarize([r for r in records if r.get("policy") == pol],
                            telemetry)
            for pol in policies
        }
    if algos:
        summary["by_algo"] = {
            algo: _summarize([r for r in records
                              if r.get("requested_algo") == algo], telemetry)
            for algo in algos
        }
    return {
        "schema": SCHEMA,
        "profile": profile,
        "seed": seed,
        "deterministic": deterministic,
        "telemetry": telemetry,
        # Best-of-N descriptor-path re-planning latency at p=1024 (Section
        # 4.3's < 1 ms claim); None on deterministic runs, where wall-clock
        # measurements are excluded so artifacts stay byte-identical.
        "schedgen_latency_ms": _round(schedgen_latency_ms, 6),
        "scenario_count": len(records),
        # Worker chunks the engine re-ran after a crash/hang; deterministic
        # per grid only in the common 0 case, but retries don't perturb
        # scenario bytes (results are pure functions of specs either way).
        "retries": retries,
        "summary": summary,
        "scenarios": records,
    }


def canonical_bytes(artifact: dict) -> bytes:
    return json.dumps(artifact, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode() + b"\n"


def write_artifact(artifact: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(canonical_bytes(artifact))


def _reject_constant(name: str) -> float:
    raise ValueError(f"non-finite JSON constant {name!r} in artifact")


def _migrate_v1(obj: dict) -> dict:
    """In-place upgrade of an optcc-sweep/1 artifact to /2 semantics:
    no telemetry, and deterministic runs' 0.0 wall-clock placeholders become
    null (v1 wrote zeros for unmeasured latencies)."""
    obj["schema"] = "optcc-sweep/2"
    obj["telemetry"] = False
    if obj.get("deterministic"):
        for rec in obj.get("scenarios", ()):
            for key in _SCENARIO_LATENCY:
                rec[key] = None
        summary = obj.get("summary", {})
        groups = [summary.get("overall", {})]
        groups.extend(summary.get("by_family", {}).values())
        for stats in groups:
            stats["gen_ms_p50"] = stats["gen_ms_p99"] = None
    return obj


def _migrate_v2(obj: dict) -> dict:
    """optcc-sweep/2 -> /3: purely additive (replay fields are optional and
    a v2 artifact simply predates the replay family), so only the tag moves."""
    obj["schema"] = "optcc-sweep/3"
    return obj


def _migrate_v3(obj: dict) -> dict:
    """optcc-sweep/3 -> /4: detection fields are additive (a v3 artifact
    predates the detection family), but the engine's retry count was not
    recorded - null marks it unknown rather than claiming a clean 0."""
    obj["schema"] = "optcc-sweep/4"
    obj["retries"] = None
    return obj


def _migrate_v4(obj: dict) -> dict:
    """optcc-sweep/4 -> /5: purely additive (topology fields are optional
    and a v4 artifact predates the topology family; its overall summary
    already covers only planner-driven rows), so only the tag moves."""
    obj["schema"] = SCHEMA
    return obj


def load_artifact(path: str) -> dict:
    # NaN/Infinity would sail through every comparison in validation and
    # threshold gating (NaN > limit is False), turning the CI gate green on
    # corrupted data - reject them at parse time.
    with open(path, "rb") as f:
        obj = json.load(f, parse_constant=_reject_constant)
    if obj.get("schema") == "optcc-sweep/1":
        obj = _migrate_v1(obj)
    if obj.get("schema") == "optcc-sweep/2":
        obj = _migrate_v2(obj)
    if obj.get("schema") == "optcc-sweep/3":
        obj = _migrate_v3(obj)
    if obj.get("schema") == "optcc-sweep/4":
        obj = _migrate_v4(obj)
    return obj


# ----------------------------------------------------------------------------
# validation + regression gating
# ----------------------------------------------------------------------------

def validate_artifact(artifact: dict) -> list[str]:
    """Structural schema check; returns a list of problems (empty = valid)."""
    errs: list[str] = []
    if artifact.get("schema") != SCHEMA:
        errs.append(f"schema is {artifact.get('schema')!r}, want {SCHEMA!r}")
        return errs
    for key in ("profile", "seed", "scenario_count", "summary", "scenarios"):
        if key not in artifact:
            errs.append(f"missing top-level key {key!r}")
    if errs:
        return errs
    scenarios = artifact["scenarios"]
    telemetry = bool(artifact.get("telemetry"))
    if artifact["scenario_count"] != len(scenarios):
        errs.append(f"scenario_count {artifact['scenario_count']} != "
                    f"len(scenarios) {len(scenarios)}")
    names = set()
    for i, rec in enumerate(scenarios):
        rec_errs: list[str] = []
        for key, typ in _SCENARIO_REQUIRED.items():
            if key not in rec:
                rec_errs.append(f"scenario[{i}] missing {key!r}")
            elif typ is float:
                if not isinstance(rec[key], (int, float)):
                    rec_errs.append(f"scenario[{i}].{key} not numeric")
            elif not isinstance(rec[key], typ):
                rec_errs.append(f"scenario[{i}].{key} not {typ.__name__}")
        for key in _SCENARIO_LATENCY:
            if key not in rec:
                rec_errs.append(f"scenario[{i}] missing {key!r}")
            elif rec[key] is not None and not isinstance(rec[key],
                                                        (int, float)):
                rec_errs.append(f"scenario[{i}].{key} not numeric or null")
        if rec_errs:
            errs.extend(rec_errs)
            continue
        if rec["name"] in names:
            errs.append(f"duplicate scenario name {rec['name']!r}")
        names.add(rec["name"])
        if rec["t_optcc"] < rec["lower_bound"] * (1 - 1e-9):
            errs.append(f"{rec['name']}: t_optcc beats the lower bound")
        if rec["overhead_lb"] > rec["overhead_optcc"] * (1 + 1e-9):
            errs.append(f"{rec['name']}: overhead_lb > overhead_optcc")
        if rec["family"] in ("replay", "detection"):
            fam = rec["family"]
            if not isinstance(rec.get("t_noreplan"), (int, float)):
                errs.append(f"{rec['name']}: {fam} scenario lacks "
                            f"t_noreplan")
            elif not isinstance(rec.get("replans"), int) \
                    or rec["replans"] < 0:
                errs.append(f"{rec['name']}: {fam} scenario needs a "
                            f"non-negative int 'replans'")
            elif not isinstance(rec.get("events"), list) or not rec["events"]:
                errs.append(f"{rec['name']}: {fam} scenario lacks its "
                            f"'events' timeline")
            elif rec["t_optcc"] > rec["t_noreplan"] * (1 + 1e-9):
                errs.append(f"{rec['name']}: adopted t_optcc exceeds the "
                            f"no-replan baseline (the controller must take "
                            f"the better schedule)")
        elif "t_noreplan" in rec:
            errs.append(f"{rec['name']}: t_noreplan on a non-replay "
                        f"scenario")
        if rec["family"] == "detection":
            if not isinstance(rec.get("policy"), str):
                errs.append(f"{rec['name']}: detection scenario lacks its "
                            f"controller 'policy'")
            if not isinstance(rec.get("detection"), dict):
                errs.append(f"{rec['name']}: detection scenario lacks its "
                            f"'detection' parameter block")
            if not isinstance(rec.get("t_oracle"), (int, float)):
                errs.append(f"{rec['name']}: detection scenario lacks "
                            f"t_oracle")
            elif not isinstance(rec.get("overhead_vs_oracle"), (int, float)):
                errs.append(f"{rec['name']}: detection scenario lacks "
                            f"overhead_vs_oracle")
            for key in ("false_replans", "suppressed", "detect_missed"):
                if not isinstance(rec.get(key), int) or rec[key] < 0:
                    errs.append(f"{rec['name']}: detection scenario needs a "
                                f"non-negative int {key!r}")
            for key in ("detect_lag_mean", "detect_lag_max"):
                if key not in rec:
                    errs.append(f"{rec['name']}: detection scenario "
                                f"missing {key!r}")
                elif rec[key] is not None and not isinstance(rec[key],
                                                             (int, float)):
                    errs.append(f"{rec['name']}.{key} not numeric or null")
        elif "policy" in rec:
            errs.append(f"{rec['name']}: policy on a non-detection scenario")
        if rec["family"] == "topology":
            if not isinstance(rec.get("requested_algo"), str):
                errs.append(f"{rec['name']}: topology scenario lacks "
                            f"requested_algo")
            if not isinstance(rec.get("t_auto"), (int, float)):
                errs.append(f"{rec['name']}: topology scenario lacks t_auto")
            elif not isinstance(rec.get("overhead_vs_auto"), (int, float)):
                errs.append(f"{rec['name']}: topology scenario lacks "
                            f"overhead_vs_auto")
        elif "t_auto" in rec or "requested_algo" in rec:
            errs.append(f"{rec['name']}: topology fields on a non-topology "
                        f"scenario")
        sb = rec.get("stage_breakdown")
        if telemetry:
            # The tentpole invariant, enforced on every telemetry artifact:
            # critical-path stage contributions account for the *entire*
            # simulated time (1e-6 relative absorbs the 9-digit rounding).
            # Replay rows attribute the no-replan run, so they sum to
            # t_noreplan; everything else sums to t_optcc.
            if not isinstance(sb, dict) or not sb:
                errs.append(f"{rec['name']}: telemetry artifact lacks "
                            f"stage_breakdown")
            else:
                ref_key = "t_noreplan" if "t_noreplan" in rec else "t_optcc"
                ref = rec[ref_key]
                total = sum(sb.values())
                if abs(total - ref) > 1e-6 * max(ref, 1.0):
                    errs.append(
                        f"{rec['name']}: stage_breakdown sums to "
                        f"{total:.9g}, {ref_key} is {ref:.9g}")
        elif sb is not None:
            errs.append(f"{rec['name']}: stage_breakdown present but "
                        f"telemetry is off")
    summary = artifact["summary"]
    if any(rec.get("family") == "detection" for rec in scenarios) \
            and "by_policy" not in summary:
        errs.append("artifact has detection scenarios but no "
                    "summary.by_policy block")
    if any("requested_algo" in rec for rec in scenarios) \
            and "by_algo" not in summary:
        errs.append("artifact has topology scenarios but no "
                    "summary.by_algo block")
    for group, stats in [("overall", summary.get("overall", {}))] + \
            sorted(summary.get("by_family", {}).items()) + \
            sorted(summary.get("by_policy", {}).items()) + \
            sorted(summary.get("by_algo", {}).items()):
        for key in _SUMMARY_KEYS:
            if key not in stats:
                errs.append(f"summary[{group}] missing {key!r}")
        if telemetry and "stages" not in stats:
            errs.append(f"summary[{group}] missing 'stages' block")
    return errs


def check_thresholds(artifact: dict, thresholds: dict) -> list[str]:
    """Regression gate: compare the artifact's summary against a checked-in
    thresholds file. Returns failures (empty = pass)."""
    fails: list[str] = []
    if thresholds.get("schema") != THRESHOLDS_SCHEMA:
        fails.append(f"thresholds schema is {thresholds.get('schema')!r}, "
                     f"want {THRESHOLDS_SCHEMA!r}")
        return fails
    overall = artifact["summary"]["overall"]
    checks = [
        ("overhead_optcc_p99", "p99 OptCC overhead vs fault-free T0"),
        ("overhead_optcc_max", "max OptCC overhead vs fault-free T0"),
        ("optcc_vs_lb_p99", "p99 OptCC time vs information-theoretic bound"),
        ("optcc_vs_lb_max", "max OptCC time vs information-theoretic bound"),
    ]
    for key, label in checks:
        limit = thresholds.get(f"{key}_max")
        if limit is None:
            continue
        got = overall[key]
        if got > limit:
            fails.append(f"{label}: {got:.6g} > limit {limit:.6g} ({key})")
    # Per-stage gates: {stage: p99 overhead limit}. A thresholds file that
    # names stages demands a telemetry artifact - a sweep run without
    # --telemetry must fail loudly, not skip the gate.
    stage_limits = thresholds.get("stage_overhead_p99_max") or {}
    if stage_limits:
        stages = overall.get("stages")
        if stages is None:
            fails.append("thresholds gate per-stage overheads but the "
                         "artifact has no stage telemetry (run the sweep "
                         "with --telemetry)")
        else:
            for stage, limit in sorted(stage_limits.items()):
                st = stages.get(stage)
                if st is None:
                    fails.append(f"stage {stage!r} gated but absent from "
                                 f"the sweep's critical paths")
                    continue
                got = st["overhead_p99"]
                if got > limit:
                    fails.append(
                        f"critical-path p99 overhead of stage {stage}: "
                        f"{got:.6g} > limit {limit:.6g} "
                        f"(stage_overhead_p99_max.{stage})")
    # Per-family gates: {family: {"<metric>_max": limit, "min_scenarios": N}}.
    # A family named in the thresholds file MUST be present in the artifact -
    # a grid regression that silently drops a family (e.g. the replay
    # scenarios failing to generate) must fail the gate, not skip it.
    fam_limits = thresholds.get("families") or {}
    by_family = artifact["summary"].get("by_family", {})
    for fam, limits in sorted(fam_limits.items()):
        stats = by_family.get(fam)
        if stats is None:
            fails.append(f"family {fam!r} is threshold-gated but absent "
                         f"from the artifact (present: "
                         f"{sorted(by_family)}); the grid lost a scenario "
                         f"family")
            continue
        for key, limit in sorted(limits.items()):
            if key == "min_scenarios":
                if stats["count"] < limit:
                    fails.append(f"family {fam}: count {stats['count']} < "
                                 f"required {limit}")
                continue
            metric = key[:-4] if key.endswith("_max") else key
            got = stats.get(metric)
            if got is None:
                fails.append(f"family {fam}: summary lacks {metric!r} "
                             f"(gated by families.{fam}.{key})")
            elif got > limit:
                fails.append(f"family {fam}: {metric} {got:.6g} > limit "
                             f"{limit:.6g} (families.{fam}.{key})")
    min_scen = thresholds.get("min_scenarios")
    if min_scen is not None and artifact["scenario_count"] < min_scen:
        fails.append(f"scenario_count {artifact['scenario_count']} < "
                     f"required {min_scen}")
    lat_limit = thresholds.get("schedgen_latency_ms_max")
    if lat_limit is not None:
        lat = artifact.get("schedgen_latency_ms")
        # None = deterministic run (latency deliberately unmeasured); the
        # gate only fires on measured values.
        if lat is not None and lat > lat_limit:
            fails.append(f"schedule-generation latency at p=1024: "
                         f"{lat:.6g} ms > limit {lat_limit:.6g} ms "
                         f"(schedgen_latency_ms)")
    return fails
