"""Scenario sweep engine: grid -> (plan, simulate, score) -> artifact rows.

Each scenario runs the full online path a production deployment would:
`planner.make_plan` builds the OptCC schedule for the degraded profile
(timed - this is the claimed <1ms re-planning latency), `core.simulate`
executes it in the bandwidth-bound flow model, and the result is scored
against the profile's information-theoretic lower bound and the fault-free
optimum T0. Optionally the unchanged degraded ring (the ICCL baseline) is
simulated on the same profile for a head-to-head overhead comparison.

Scenario execution is embarrassingly parallel; `run_sweep` fans the grid out
over worker processes via core.simulator.map_scenarios (workers=0 -> serial,
same results - the model is deterministic).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Optional, Sequence

from repro_torch.core.planner import make_plan
from repro_torch.core.schedule_vec import ring_arrays
from repro_torch.core.simulator import simulate
from repro_torch.sweeps.scenarios import GRIDS, ScenarioSpec


@dataclasses.dataclass
class ScenarioResult:
    """Scored outcome of one scenario. Times are element-time units."""

    spec: ScenarioSpec
    algo: str
    t_optcc: float                 # simulated OptCC completion time
    t_ring: Optional[float]        # simulated degraded ring (ICCL), if run
    t_predicted: float             # planner's closed-form prediction
    lower_bound: float             # tightest applicable theorem
    t0: float                      # fault-free optimum (Patarasuk-Yuan)
    num_flows: int
    gen_seconds: float             # schedule-generation wall time
    sim_seconds: float             # OptCC simulation wall time (not a claim)
    ring_sim_seconds: float = 0.0  # ring-baseline simulation wall time
    # Critical-path stage attribution ({stage: element-time}, sums to
    # t_optcc); only populated when the sweep runs with telemetry on.
    stage_breakdown: Optional[dict] = None
    # Replay-family fields (spec.events non-empty). t_optcc then carries the
    # *adopted* makespan - the re-planning controller rides the original
    # plan or splices in fresh ones, whichever is better - so every
    # overhead metric keeps meaning "what the system achieved". t_noreplan
    # is the original plan ridden through the whole timeline (the baseline
    # re-planning is scored against); stage_breakdown attributes *it*, so
    # for replay scenarios the breakdown sums to t_noreplan, not t_optcc.
    t_noreplan: Optional[float] = None
    replans: Optional[int] = None
    # Topology-family fields (spec.algo != "auto"). The scenario plans the
    # *explicitly requested* registry algorithm - t_optcc is its simulated
    # makespan and lower_bound its per-topology bound - and additionally
    # simulates what make_plan(algo="auto") would have run on the very same
    # profile, so overhead_vs_auto prices the topology against the planner's
    # choice (>1: auto was right to avoid it; <1: the time models leave
    # wins on the table).
    requested_algo: Optional[str] = None
    t_auto: Optional[float] = None
    # Detection-family fields (spec.detection non-empty). t_optcc is the
    # *imperfect* controller's adopted makespan; t_oracle the PR-8
    # zero-delay perfect-knowledge controller's on the same timeline, so
    # overhead_vs_oracle prices the detection imperfection itself.
    policy: Optional[str] = None
    t_oracle: Optional[float] = None
    false_replans: Optional[int] = None
    suppressed: Optional[int] = None
    detect_lag_mean: Optional[float] = None
    detect_lag_max: Optional[float] = None
    detect_missed: Optional[int] = None

    @property
    def overhead_optcc(self) -> float:
        """Simulated time vs the fault-free optimum (the paper's metric)."""
        return self.t_optcc / self.t0

    @property
    def overhead_noreplan(self) -> Optional[float]:
        return None if self.t_noreplan is None else self.t_noreplan / self.t0

    @property
    def overhead_ring(self) -> Optional[float]:
        return None if self.t_ring is None else self.t_ring / self.t0

    @property
    def overhead_vs_oracle(self) -> Optional[float]:
        """Price of imperfect detection: imperfect controller's adopted
        makespan vs the zero-delay perfect-knowledge controller's."""
        return None if self.t_oracle is None else self.t_optcc / self.t_oracle

    @property
    def overhead_vs_auto(self) -> Optional[float]:
        """Requested topology vs the planner's auto pick, same profile."""
        return None if self.t_auto is None else self.t_optcc / self.t_auto

    @property
    def overhead_lb(self) -> float:
        """Unavoidable overhead: no algorithm can beat this."""
        return self.lower_bound / self.t0

    @property
    def optcc_vs_lb(self) -> float:
        """Schedule quality: simulated time vs the lower bound (>= 1 always,
        or the simulator/bound is broken)."""
        return self.t_optcc / self.lower_bound


def run_scenario(spec: ScenarioSpec,
                 measure_latency: bool = True,
                 telemetry: bool = False) -> ScenarioResult:
    """Plan + simulate + score one scenario.

    telemetry=True additionally attributes the simulated makespan to OptCC
    stages along the critical path (`repro_torch.obs`). Attribution is derived
    *after* the timed simulation from its recorded flow times, so t_optcc is
    bit-identical with and without it.

    Specs with a failure timeline (`spec.events`, the replay family) run the
    time-varying path instead: t_optcc is the makespan the mid-flight
    re-planning controller achieves, and the original plan ridden through
    the whole timeline lands in t_noreplan.

    Specs naming an explicit algorithm (`spec.algo != "auto"`, the topology
    family) plan that registry entry instead of letting the planner choose,
    and score it against both its per-topology lower bound and the auto
    pick on the same profile (`t_auto` / overhead_vs_auto).
    """
    if spec.events:
        return _run_replay_scenario(spec, measure_latency=measure_latency,
                                    telemetry=telemetry)
    if spec.algo != "auto":
        return _run_topology_scenario(spec, measure_latency=measure_latency,
                                      telemetry=telemetry)
    profile = spec.profile()
    plan = make_plan(profile, spec.n, k=spec.k,
                     fill_bubbles=spec.fill_bubbles, materialize="arrays")
    t_sim0 = time.perf_counter()
    res = simulate(plan.schedule)
    t_optcc = res.makespan
    sim_seconds = time.perf_counter() - t_sim0
    stage_breakdown = None
    if telemetry:
        from repro_torch import obs
        stage_breakdown = obs.stage_breakdown(obs.collect(plan.schedule, res))
    t_ring = None
    ring_sim_seconds = 0.0
    if spec.simulate_ring:
        if plan.schedule.meta.get("algo") == "ring":
            t_ring = t_optcc          # healthy: the plan already is the ring
        else:
            t_ring0 = time.perf_counter()
            t_ring = simulate(ring_arrays(profile, spec.n)).makespan
            ring_sim_seconds = time.perf_counter() - t_ring0
    return ScenarioResult(
        spec=spec,
        algo=plan.algo,
        t_optcc=t_optcc,
        t_ring=t_ring,
        t_predicted=plan.predicted_time,
        lower_bound=plan.lower_bound,
        t0=plan.t0,
        num_flows=plan.schedule.num_flows,
        gen_seconds=plan.gen_seconds if measure_latency else 0.0,
        sim_seconds=sim_seconds if measure_latency else 0.0,
        ring_sim_seconds=ring_sim_seconds if measure_latency else 0.0,
        stage_breakdown=stage_breakdown,
    )


def _run_topology_scenario(spec: ScenarioSpec,
                           measure_latency: bool = True,
                           telemetry: bool = False) -> ScenarioResult:
    """Topology-family scenario: plan the explicitly requested registry
    algorithm (hierarchical / dbtree / torus2d / ...), simulate it, and
    score it twice - against its *own* per-topology lower bound (the
    optcc_vs_lb column, gated per-family in CI) and against the makespan
    `make_plan(algo="auto")` achieves on the identical profile (t_auto, so
    overhead_vs_auto says what explicitly requesting this topology costs or
    saves vs trusting the planner)."""
    profile = spec.profile()
    plan = make_plan(profile, spec.n, k=spec.k,
                     fill_bubbles=spec.fill_bubbles, materialize=True,
                     algo=spec.algo)
    t_sim0 = time.perf_counter()
    res = simulate(plan.schedule)
    t_topo = res.makespan
    sim_seconds = time.perf_counter() - t_sim0
    stage_breakdown = None
    if telemetry:
        from repro_torch import obs
        stage_breakdown = obs.stage_breakdown(obs.collect(plan.schedule, res))
    auto_plan = make_plan(profile, spec.n, k=spec.k,
                          fill_bubbles=spec.fill_bubbles,
                          materialize="arrays")
    t_auto = simulate(auto_plan.schedule).makespan
    return ScenarioResult(
        spec=spec,
        algo=plan.algo,
        t_optcc=t_topo,
        t_ring=None,
        t_predicted=plan.predicted_time,
        lower_bound=plan.lower_bound,
        t0=plan.t0,
        num_flows=plan.schedule.num_flows,
        gen_seconds=plan.gen_seconds if measure_latency else 0.0,
        sim_seconds=sim_seconds if measure_latency else 0.0,
        stage_breakdown=stage_breakdown,
        requested_algo=spec.algo,
        t_auto=t_auto,
    )


def _run_replay_scenario(spec: ScenarioSpec,
                         measure_latency: bool = True,
                         telemetry: bool = False) -> ScenarioResult:
    """Replay-family scenario: one collective under a failure timeline,
    scored with and without mid-flight re-planning.

    The spec's event times are in units of the scenario's fault-free optimum
    T0, so the same trace shape is meaningful at every (p, n, k); they are
    rescaled to element-time here. t_optcc carries the controller's adopted
    makespan (so every overhead metric scores the system's actual behavior),
    t_noreplan the original plan ridden through the whole timeline, and the
    lower bound is the timeline bound (static bound of the per-rank
    best-ever rates).
    """
    from repro_torch.core import lower_bounds as lb
    from repro_torch.core.model import FaultTimeline
    from repro_torch.core.planner import replay

    profile = spec.profile()
    scale = lb.t0_fault_free(spec.p, spec.n, spec.gpus_per_server)
    tl = FaultTimeline.make([(t * scale, r, l) for t, r, l in spec.events])

    detector = controller = None
    if spec.detection:
        from repro_torch.detect import ControllerConfig, DetectorConfig
        params = dict(spec.detection)
        policy = str(params.pop("policy", "immediate"))
        # Detection time parameters are specified in T0 units like the
        # trace events; rescale them to element-time alongside.
        detector = DetectorConfig(
            probe_interval=float(params.get("probe_interval", 0.0)) * scale,
            latency=float(params.get("latency", 0.0)) * scale,
            noise=float(params.get("noise", 0.0)),
            quant=float(params.get("quant", 0.0)),
            fp_rate=float(params.get("fp_rate", 0.0)),
            fn_rate=float(params.get("fn_rate", 0.0)),
            seed=int(params.get("seed", 0)),
        )
        controller = ControllerConfig(
            policy=policy,
            debounce_probes=int(params.get("debounce_probes", 3)),
            backoff_base=float(params.get("backoff_base", 0.0)) * scale,
        )

    t_sim0 = time.perf_counter()
    rr = replay(profile, spec.n, tl, k=spec.k,
                fill_bubbles=spec.fill_bubbles,
                detector=detector, controller=controller)
    sim_seconds = time.perf_counter() - t_sim0
    t_oracle = None
    if spec.detection:
        # Score the imperfect controller against the PR-8 zero-delay
        # perfect-knowledge chain on the very same true timeline.
        rr_oracle = replay(profile, spec.n, tl, k=spec.k,
                           fill_bubbles=spec.fill_bubbles)
        t_oracle = rr_oracle.t_replan
    plan0 = rr.plan0
    stage_breakdown = None
    if telemetry:
        from repro_torch import obs
        stage_breakdown = obs.stage_breakdown(
            obs.collect(plan0.schedule, rr.noreplan_result))
    det = rr.detection
    return ScenarioResult(
        spec=spec,
        algo=plan0.algo,
        t_optcc=rr.t_replan,
        t_ring=None,
        t_predicted=plan0.predicted_time,
        lower_bound=rr.lower_bound,
        t0=rr.t0,
        num_flows=plan0.schedule.num_flows,
        gen_seconds=plan0.gen_seconds if measure_latency else 0.0,
        sim_seconds=sim_seconds if measure_latency else 0.0,
        stage_breakdown=stage_breakdown,
        t_noreplan=rr.t_noreplan,
        replans=rr.replans,
        policy=rr.policy if spec.detection else None,
        t_oracle=t_oracle,
        false_replans=rr.false_replans if spec.detection else None,
        suppressed=rr.suppressed if spec.detection else None,
        detect_lag_mean=rr.detect_lag_mean if spec.detection else None,
        detect_lag_max=rr.detect_lag_max if spec.detection else None,
        detect_missed=det.missed if det is not None else None,
    )


def _run_chunk(fn, chunk: list[ScenarioSpec]) -> list[ScenarioResult]:
    """Worker-side unit of the fan-out: one chunk of specs, in order.
    Module-level so it pickles into the process pool."""
    return [fn(spec) for spec in chunk]


def run_sweep(specs: Sequence[ScenarioSpec], workers: int = 0,
              measure_latency: bool = True,
              telemetry: bool = False,
              stats: Optional[dict] = None,
              chunk_timeout: float = 300.0,
              max_retries: int = 2) -> list[ScenarioResult]:
    """Run a scenario grid, preserving grid order.

    measure_latency=False zeroes all wall-clock fields, making the results -
    and the artifact built from them - a pure function of the grid
    (byte-identical across runs; the determinism CI check uses this).
    telemetry=True populates each result's stage_breakdown (deterministic
    too: attribution is pure arithmetic on simulated times).

    The parallel fan-out is crash/hang-hardened: the grid is split into
    chunks, and a chunk whose worker dies (BrokenProcessPool / OSError) or
    hangs past `chunk_timeout` seconds is re-submitted to a fresh pool up to
    `max_retries` times with exponential backoff; whatever still fails after
    that runs serially in-process (scenarios are pure functions of their
    specs, so re-running is always safe and bit-identical). Pass a `stats`
    dict to receive {"retries": <chunk re-submissions>} - the sweep CLI
    records it in the artifact. Deterministic errors raised by a scenario
    itself (e.g. an invalid spec) are not retried; they propagate.
    """
    # partial of a module-level function pickles, so the process pool works.
    fn = functools.partial(run_scenario, measure_latency=measure_latency,
                           telemetry=telemetry)
    if stats is None:
        stats = {}
    stats.setdefault("retries", 0)
    specs = list(specs)
    if workers <= 0 or len(specs) <= 1:
        return [fn(s) for s in specs]

    csize = max(1, len(specs) // (8 * workers))
    pending = [(i, specs[i:i + csize]) for i in range(0, len(specs), csize)]
    results: list[Optional[ScenarioResult]] = [None] * len(specs)

    for attempt in range(max_retries + 1):
        if not pending:
            break
        if attempt:
            stats["retries"] += len(pending)
            time.sleep(0.25 * (2 ** (attempt - 1)))
        try:
            pool = ProcessPoolExecutor(max_workers=workers)
        except OSError:
            break                      # cannot pool at all -> serial below
        failed: list[tuple[int, list[ScenarioSpec]]] = []
        futs = {pool.submit(_run_chunk, fn, chunk): (start, chunk)
                for start, chunk in pending}
        try:
            while futs:
                # Hang detection is progress-based: the round only aborts
                # when *no* chunk completes for chunk_timeout seconds, so a
                # long grid that is still making progress never false-fires.
                done, _ = concurrent.futures.wait(
                    futs, timeout=chunk_timeout,
                    return_when=concurrent.futures.FIRST_COMPLETED)
                if not done:
                    failed.extend(futs.values())  # hung (or queued behind one)
                    futs.clear()
                    break
                for fut in done:
                    start, chunk = futs.pop(fut)
                    try:
                        results[start:start + len(chunk)] = fut.result()
                    except (OSError, BrokenProcessPool):
                        failed.append((start, chunk))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        pending = sorted(failed)

    for start, chunk in sorted(pending):   # last resort: serial, in-process
        results[start:start + len(chunk)] = [fn(s) for s in chunk]
    return results


def grid_for(profile: str, seed: int = 0) -> list[ScenarioSpec]:
    try:
        return GRIDS[profile](seed)
    except KeyError:
        raise ValueError(f"unknown sweep profile {profile!r}; "
                         f"choose from {sorted(GRIDS)}") from None


def sanity_check(results: Sequence[ScenarioResult],
                 tol: float = 1e-9) -> list[str]:
    """Model-level invariant violations (empty list = all good):
    simulated time must dominate the information-theoretic lower bound."""
    bad = []
    for r in results:
        if r.t_optcc < r.lower_bound * (1.0 - tol):
            bad.append(f"{r.spec.name}: simulated {r.t_optcc:.6g} < "
                       f"lower bound {r.lower_bound:.6g}")
        if r.t_noreplan is not None and r.t_optcc > r.t_noreplan * (1.0 + tol):
            bad.append(f"{r.spec.name}: replanned {r.t_optcc:.6g} > "
                       f"no-replan {r.t_noreplan:.6g} (controller must "
                       f"adopt the better schedule)")
    return bad
