"""Online re-planning: bandwidth profile -> collective plan.

When the runtime's failure detector reports a degradation event (NIC loss,
rerouted link, egress fault), the planner picks the schedule for the
new bandwidth profile. Generation is closed-form (O(p k), Section 4.3) - no
solver - so this happens inline at failure-detection time; the paper reports
< 1 ms for p=1024; chip_smoke.py's `schedules` phase measures ours.

The plan also carries the theory: the lower bound for the profile and the
predicted completion time, so the runtime can (a) sanity-check the simulator
against the theory and (b) expose expected-overhead metrics to operators.

The port's copy of `repro/core/planner.py`: every registry name, the O(p k)
slot descriptor, the Flow-object and columnar schedules and `replay`. The
deprecated ``force_ring=`` keyword is not ported (``algo="ring"``).
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping

import numpy as np

from repro_torch.core import lower_bounds as lb
from repro_torch.core import registry
from repro_torch.core.model import BandwidthProfile, FaultTimeline, Schedule
from repro_torch.core.schedule import optcc_schedule


def topology_of(algo: str) -> str:
    """Normalize a plan/schedule `algo` to its registry topology name: the
    optcc dispatcher's per-regime variants ("optcc-single", "optcc-multi",
    "optcc-multigpu") all collapse to "optcc"; everything else (ring,
    hierarchical, dbtree, torus2d) is its own topology."""
    if algo.startswith("optcc"):
        return "optcc"
    return algo


@dataclasses.dataclass
class Plan:
    profile: BandwidthProfile
    schedule: Schedule | None    # None when materialize=False
    algo: str                    # "ring", "optcc-*", or a registry name
    lower_bound: float           # element-time units
    predicted_time: float        # closed-form achieved time
    t0: float                    # fault-free optimum
    gen_seconds: float           # wall time to construct the plan
    descriptor: dict = dataclasses.field(default_factory=dict)
    topology: str = ""           # registry name (topology_of(algo))

    def __post_init__(self):
        if not self.topology:
            self.topology = topology_of(self.algo)

    @property
    def predicted_overhead(self) -> float:
        """Predicted slowdown vs the fault-free optimum (1.0 = none)."""
        return self.predicted_time / self.t0 if self.t0 else float("inf")


class _SlotTable(Mapping):
    """Read-only (segment, section) -> slot-tuple view over the batched
    descriptor array. Behaves like the dict it replaced (len, [], in,
    .keys()/.items()), but construction is O(1) Python objects - tuples are
    materialized only for the entries actually read, which is what keeps the
    p=1024 descriptor under the 1 ms re-planning budget."""

    __slots__ = ("_cols",)

    def __init__(self, cols: np.ndarray):
        self._cols = cols                     # (k, ph, 5) float64

    def __getitem__(self, key):
        m, j = key
        k, ph, _ = self._cols.shape
        if not (0 <= m < k and 0 <= j < ph):
            raise KeyError(key)
        nu, t1, t2, t3, t4 = self._cols[m, j].tolist()
        return (int(nu), t1, t2, t3, t4)

    def __len__(self):
        return self._cols.shape[0] * self._cols.shape[1]

    def __iter__(self):
        k, ph, _ = self._cols.shape
        return ((m, j) for m in range(k) for j in range(ph))


def plan_descriptor(profile: BandwidthProfile, n: int, k: int) -> dict:
    """O(p k) closed-form schedule descriptor (Section 4.3's complexity
    claim): per-(segment, section) slot offsets; the per-hop flow graph is
    implied by the closed-form chain rules and only materialized when the
    runtime (or simulator) needs individual flows.

    All five slot columns are in element-time units and scale linearly with
    n (every term carries a factor of the slot width s_i; an earlier version
    subtracted raw constants from the S2/S3 slots, which broke unit
    consistency and went negative for small n). Computed as one batched
    numpy program over the (k, p-1) grid - this is the <1 ms re-planning
    path."""
    p = profile.p
    stragglers = profile.stragglers
    ell = max(profile.slowdown)
    ph = p - max(len(stragglers), 1) if stragglers else p
    s_i = n / max(k * ph, 1)
    w = max(ell, 2.0)
    body = w * ph * s_i
    m = np.arange(k, dtype=np.float64)[:, None]          # segment
    j = np.arange(ph, dtype=np.float64)[None, :]         # section
    nu = (j + m) % ph                                    # owner index
    cols = np.empty((k, ph, 5))
    cols[:, :, 0] = nu
    cols[:, :, 1] = m * body + (2.0 * nu + ph) * s_i         # S1 chain start
    cols[:, :, 2] = (m + 2) * body + (2.0 * nu - 2.0) * s_i  # S2 slot
    cols[:, :, 3] = (m + 3) * body + (2.0 * nu - 4.0) * s_i  # S3 slot
    cols[:, :, 4] = (m + 3) * body + (2.0 * nu + 2.0 * ph - 3.0) * s_i  # S4
    return {"algo": "optcc" if stragglers else "ring", "k": k,
            "body": body, "slots": _SlotTable(cols),
            # Column semantics for columns 1..4 of the slot table, matching
            # the stage vocabulary flows are tagged with (model.STAGE_NAMES)
            # so telemetry breakdowns line up with planned slot starts.
            "stage_slots": ("S1", "S2", "S3", "S4")}


def make_plan(profile: BandwidthProfile, n: int, k: int = 16,
              fill_bubbles: bool = True,
              materialize: bool | str = True,
              algo: str = "auto") -> Plan:
    """materialize=True -> Flow-object schedule (executor-ready);
    materialize="arrays" -> columnar schedule (simulator hot path; same
    flow graph, no Flow objects); materialize=False -> descriptor only.

    ``algo`` selects from the schedule registry (`core.registry`):

    * ``"auto"`` (default) compares the auto-eligible registered time
      models and picks the predicted-fastest. Today that is OptCC vs the
      FIFO ring, exactly the historical planner choice: the ring on a
      degraded profile costs exactly l_max 2(p-1)n/p (the slowest link
      paces a contention-free ring), so when OptCC's pipeline fill would
      cost more - small p, shallow k, l close to 1 - staying on the ring
      is the right call, and the calibrated optcc_time (within 10% of the
      simulator) makes the comparison
      trustworthy at planning time. Ties go to the ring.
    * ``"ring"`` plans the FIFO ring unconditionally - the mis-plan
      fallback `replay` takes when a fault detector's estimate is not
      credible enough to pick a straggler set from
      (`repro_torch.detect.estimate_usable`). The ring is valid under any
      profile, including ones OptCC's closed form would degenerate on
      (e.g. an estimate claiming p-1 stragglers).
    * ``"optcc"`` plans the paper's schedule family unconditionally.
    * any other registered name (``"hierarchical"``, ``"dbtree"``,
      ``"torus2d"``, ...) plans that topology; its `lower_bound` /
      `predicted_time` come from the registry entry's own bound and time
      model. Raises ValueError for unknown names or unsupported profiles."""
    if algo in ("auto", "ring", "optcc"):
        return _make_plan_classic(profile, n, k, fill_bubbles, materialize,
                                  algo)
    t_start = time.perf_counter()
    entry = registry.get(algo)
    if not entry.supports(profile):
        raise ValueError(
            f"algo {algo!r} does not support this profile "
            f"(p={profile.p}, gpus_per_server={profile.gpus_per_server}); "
            f"supported here: {', '.join(registry.supported(profile))}")
    if materialize == "arrays":
        gen = entry.generate_arrays or entry.generate
        schedule = gen(profile, n, k, fill_bubbles)
    elif materialize:
        schedule = entry.generate(profile, n, k, fill_bubbles)
    else:
        schedule = None
    gen_s = time.perf_counter() - t_start
    plan_algo = schedule.meta["algo"] if schedule is not None else algo
    return Plan(
        profile=profile,
        schedule=schedule,
        algo=plan_algo,
        lower_bound=entry.lower_bound(profile, n),
        predicted_time=entry.time_model(profile, n, k),
        t0=lb.t0_fault_free(profile.p, n, profile.gpus_per_server),
        gen_seconds=gen_s,
        descriptor={"algo": algo, "k": k},
        topology=topology_of(plan_algo),
    )


def _make_plan_classic(profile: BandwidthProfile, n: int, k: int,
                       fill_bubbles: bool, materialize: bool | str,
                       algo: str) -> Plan:
    """The OptCC-vs-ring planner (algo in auto/ring/optcc). Kept as one
    inline path - not a loop over registry entries - so `algo="auto"` stays
    bit-identical to the classic planner; the registry's ring/optcc time
    models mirror these expressions and tests/test_torch_schedules.py pins the
    equality."""
    t_start = time.perf_counter()
    g = profile.gpus_per_server
    ells = [l for l in profile.slowdown if l > 1.0]
    # De-duplicate per-server slowdowns in the multi-GPU case.
    if g > 1 and ells:
        ells = [max(ells)]
    ring_pred = max(profile.slowdown) * lb.t0_fault_free(profile.p, n, 1)
    if algo == "ring":
        optcc_pred = ring_pred
        use_ring = True
        descriptor = {"algo": "ring", "k": k}
    else:
        optcc_pred = lb.optcc_time(profile.p, n, ells, k, g)
        use_ring = (algo == "auto"
                    and ring_pred <= optcc_pred)  # healthy ties -> ring
        descriptor = plan_descriptor(profile, n, k)
    if use_ring:
        descriptor["algo"] = "ring"
    if materialize == "arrays":
        from repro_torch.core.schedule_vec import optcc_schedule_arrays, ring_arrays
        schedule = ring_arrays(profile, n) if use_ring else \
            optcc_schedule_arrays(profile, n, k, fill_bubbles)
    elif materialize:
        if use_ring:
            from repro_torch.core.ring import ring_allreduce_schedule
            schedule = ring_allreduce_schedule(profile, n)
        else:
            schedule = optcc_schedule(profile, n, k, fill_bubbles)
    else:
        schedule = None
    gen_s = time.perf_counter() - t_start
    if schedule is not None:
        plan_algo = schedule.meta["algo"]
    elif use_ring:
        plan_algo = "ring"
    elif g > 1:
        plan_algo = "optcc-multigpu"
    else:
        plan_algo = "optcc-single" if len(ells) == 1 else "optcc-multi"
    return Plan(
        profile=profile,
        schedule=schedule,
        algo=plan_algo,
        lower_bound=lb.lower_bound(profile.p, n, ells, g),
        predicted_time=ring_pred if use_ring else optcc_pred,
        t0=lb.t0_fault_free(profile.p, n, g),
        gen_seconds=gen_s,
        descriptor=descriptor,
        topology=topology_of(plan_algo),
    )


@dataclasses.dataclass
class ReplayResult:
    """Outcome of `replay`: one collective run under a failure timeline,
    with and without mid-flight re-planning.

    ``t_noreplan`` is the original plan ridden through every rate change;
    ``t_chain`` is the replanned chain's completion time (splice at each
    breakpoint: drain the in-flight flows, re-plan the remaining elements
    for the rates then in force, repeat on the residual timeline). The
    controller modeled here sees both and adopts the better one, so the
    reported ``t_replan`` is their min - re-planning can only help.
    """

    profile: BandwidthProfile      # base profile (timeline t=0 events folded)
    timeline: FaultTimeline
    n: float
    t_noreplan: float              # original plan under the full timeline
    t_chain: float                 # replanned chain completion time
    replans: int                   # splices performed along the chain
    lower_bound: float             # timeline_lower_bound (best-ever rates)
    t0: float                      # fault-free optimum for (p, n, g)
    plan0: Plan                    # the initial plan (before any splice)
    # SimResult of the no-replan run (plan0 under the full timeline) - kept
    # so callers can attribute t_noreplan per stage (repro_torch.obs) without
    # re-simulating.
    noreplan_result: object = None
    # Imperfect-detection fields (repro_torch.detect). policy="oracle" marks the
    # zero-delay perfect-knowledge controller (detector=None).
    policy: str = "oracle"
    detector: object = None        # detect.DetectorConfig | None
    detection: object = None       # detect.DetectionResult | None
    false_replans: int = 0         # splices with no true rate change behind
    suppressed: int = 0            # estimated changes the policy swallowed

    @property
    def t_replan(self) -> float:
        """Makespan with the re-planning controller on (adopts the better)."""
        return min(self.t_chain, self.t_noreplan)

    @property
    def adopted_replan(self) -> bool:
        return self.t_chain < self.t_noreplan

    @property
    def detect_lag_mean(self) -> float | None:
        return None if self.detection is None else self.detection.lag_mean

    @property
    def detect_lag_max(self) -> float | None:
        return None if self.detection is None else self.detection.lag_max


def replay(profile: BandwidthProfile, n: int, timeline: FaultTimeline,
           k: int = 16, fill_bubbles: bool = True,
           max_replans: int = 8,
           detector: object = None,
           controller: object = None) -> ReplayResult:
    """Run one AllReduce under a failure timeline, re-planning mid-flight.

    The no-replan baseline simulates the initial plan (built for the
    profile in force at t=0, timeline t<=0 events folded in) under the full
    timeline. The replan chain models the runtime's failure detector firing
    at each effective breakpoint b:

      * flows already on the wire at b drain to completion (they hold their
        ports and never wait again, so their finishes in the no-replan
        simulation are already exact);
      * flows not yet started are cancelled; the work they carried -
        ``(1 - progress)`` of the current vector, measured in NIC wire
        elements - is re-planned from scratch via `make_plan` against the
        profile in force at the drain time, and the residual timeline
        (later events, shifted to the new plan's clock) recurses.

    With ``detector=None`` (the default) the controller is the
    *oracle*: zero detection latency, perfect knowledge of the new rates.
    The adopted result is ``min(chain, no-replan)``: see `ReplayResult`.

    With a `repro_torch.detect.DetectorConfig`, the controller reacts to the
    *estimated* timeline instead: triggers are the breakpoints of the
    detector's estimate (lagged, noisy, possibly spurious), filtered by the
    `repro_torch.detect.ControllerConfig` policy (``immediate`` / ``debounce`` /
    ``backoff``), and every spliced plan is built from the estimated
    profile at the drain time. Execution stays truth-grounded - mis-plan
    tolerance: the (possibly wrong) schedule is simulated under the *true*
    rates by folding per-rank truth corrections into the simulation
    timeline at t=0, so a plan built for the wrong straggler or wrong ell
    still yields a valid, correctly-timed run; when the estimate is not
    credible enough to pick a straggler set from
    (`repro_torch.detect.estimate_usable`) the splice falls back to the degraded
    FIFO ring. A perfect detector with the ``immediate`` policy reproduces
    the oracle bit-for-bit (tests/test_torch_replay.py holds it).

    The strict wins come from slotted OptCC's release times: they are
    computed for the *degraded* rates, so after a recovery the no-replan
    schedule still paces itself as if the straggler were there, while the
    replanned remainder runs at full speed.
    """
    from repro_torch.core.model import FaultEvent
    from repro_torch.core.simulator import simulate

    if max_replans < 0:
        raise ValueError("max_replans must be >= 0")
    base = timeline.profile_at(profile, 0.0)
    tl0 = timeline.after(0.0)
    plan0 = make_plan(base, n, k, fill_bubbles)
    res0 = simulate(plan0.schedule, timeline=tl0)
    t_noreplan = res0.makespan

    detection = None
    suppressed = 0
    ctrl = None
    est_tl0 = tl0
    if detector is not None:
        from repro_torch.detect import (ControllerConfig, apply_policy,
                                  estimate_timeline)
        ctrl = controller if controller is not None else ControllerConfig()
        # The horizon must cover everything the chain could react to: the
        # no-replan makespan, the last true event, plus the detector's own
        # lag sources (sensing latency, debounce window, a couple probes).
        last_ev = max((e.t for e in tl0.events), default=0.0)
        dt = detector.probe_interval
        window = (ctrl.debounce_probes - 1) * dt \
            if ctrl.policy == "debounce" else 0.0
        horizon = max(t_noreplan, last_ev) + detector.latency + window \
            + 2.0 * dt
        detection = estimate_timeline(base, tl0, horizon, detector)
        est_tl0, suppressed = apply_policy(detection, base, ctrl)
    elif controller is not None:
        raise ValueError("a controller policy needs a detector "
                         "(detector=None runs the zero-delay oracle)")

    # Replanned chain: walk trigger breakpoints, splicing a fresh plan at
    # each. Triggers and plan profiles come from the estimated view
    # (== the truth in oracle mode); drains and simulations from the truth.
    t_off = 0.0
    n_cur = float(n)
    prof_cur = base
    tl_cur = tl0
    est_prof_cur = base
    est_tl_cur = est_tl0
    plan_cur, res_cur = plan0, res0
    replans = 0
    false_replans = 0
    not_before = 0.0               # backoff floor, absolute chain time
    t_chain = t_noreplan
    while True:
        if detector is None:
            breaks, _ = tl_cur.segments(prof_cur)
        else:
            breaks, _ = est_tl_cur.segments(est_prof_cur)
        b = next((bt for bt in breaks if bt < res_cur.makespan), None)
        if b is not None and ctrl is not None and ctrl.policy == "backoff" \
                and t_off + b < not_before:
            # Defer (and thereby coalesce) triggers inside the spacing
            # floor; a floor beyond the current run's makespan ends the
            # chain - the remaining estimated changes go unanswered.
            b = not_before - t_off
            if b >= res_cur.makespan:
                b = None
        if b is None or replans >= max_replans:
            t_chain = t_off + res_cur.makespan
            break
        starts = res_cur.start
        finishes = res_cur.finish
        wire = [f for f in plan_cur.schedule.nic_flows if f.size > 0]
        started = [f for f in wire if starts[f.fid] < b]
        total_work = sum(f.size for f in wire)
        done_work = sum(f.size for f in started)
        progress = done_work / total_work if total_work else 1.0
        n_rem = int(round(n_cur * (1.0 - progress)))
        if n_rem <= 0:
            # Everything is already on the wire; nothing left to re-plan.
            t_chain = t_off + res_cur.makespan
            break
        # Drain: in-flight flows keep their ports until done, so their
        # finishes in res_cur are exact regardless of the cancellations.
        t_d = max([b] + [finishes[f.fid] for f in started])
        prev_true = prof_cur
        prof_cur = tl_cur.profile_at(prof_cur, t_d)
        tl_cur = tl_cur.after(t_d)
        if detector is None:
            est_prof_cur, est_tl_cur = prof_cur, tl_cur
        else:
            est_prof_cur = est_tl_cur.profile_at(est_prof_cur, t_d)
            est_tl_cur = est_tl_cur.after(t_d)
        t_off += t_d
        n_cur = float(n_rem)
        replans += 1
        if detector is not None \
                and prof_cur.slowdown == prev_true.slowdown:
            # The trigger had no true rate change behind it (an FP blip, or
            # a flap that cleared before the drain finished): pure thrash.
            false_replans += 1
        if detector is None:
            plan_cur = make_plan(prof_cur, n_rem, k, fill_bubbles)
            sim_tl = tl_cur
        else:
            from repro_torch.detect import estimate_usable
            plan_cur = make_plan(
                est_prof_cur, n_rem, k, fill_bubbles,
                algo="auto" if estimate_usable(est_prof_cur) else "ring")
            # Mis-plan execution: the schedule was built for the estimated
            # rates, but the wire runs at the true ones. Events SET
            # absolute per-rank values, so t=0 corrections re-ground the
            # simulation in the truth regardless of the plan's beliefs.
            corr = tuple(
                FaultEvent(0.0, r, tv)
                for r, (tv, ev) in enumerate(zip(prof_cur.slowdown,
                                                 est_prof_cur.slowdown))
                if tv != ev)
            sim_tl = FaultTimeline(corr + tl_cur.events) if corr else tl_cur
        res_cur = simulate(plan_cur.schedule, timeline=sim_tl)
        if ctrl is not None and ctrl.policy == "backoff":
            not_before = t_off + ctrl.backoff_spacing(
                detector.probe_interval, replans)

    return ReplayResult(
        profile=base,
        timeline=tl0,
        n=float(n),
        t_noreplan=t_noreplan,
        t_chain=t_chain,
        replans=replans,
        lower_bound=lb.timeline_lower_bound(base, tl0, n),
        t0=lb.t0_fault_free(base.p, n, base.gpus_per_server),
        plan0=plan0,
        noreplan_result=res0,
        policy="oracle" if detector is None else ctrl.policy,
        detector=detector,
        detection=detection,
        false_replans=false_replans,
        suppressed=suppressed,
    )
