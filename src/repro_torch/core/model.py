"""Data model for the bandwidth-bound flow abstraction of the paper.

A *flow* is a point-to-point transfer of `size` elements from `src` to `dst`
(Section 4.1). The bandwidth-bound model (Section 3, "Problem setting"):

  - a healthy NIC transmits one element per time unit;
  - a NIC with slowdown factor l > 1 takes l time units per element;
  - each NIC port (send side / recv side) carries at most one flow at a time;
  - per-message latency and cold-start terms are excluded.

A flow's duration is `size * max(l_src, l_dst)`: the slower endpoint throttles
the transfer (the paper's Stage-2/3 flows take l*s even though one endpoint is
healthy).

Flows carry semantic *tags* so that a single schedule object can be both
timed (core.simulator) and executed on real data (core.executor).

The port's copy of `repro/core/model.py`: numpy and plain Python, so the
flow graph, the schedules built on it and their timing are the JAX
package's to the bit; only the executor moves torch tensors.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


# Canonical pipeline-stage vocabulary for flow tagging (observability layer).
# Generators stamp every flow with one of these so telemetry / critical-path
# attribution can localize a regression to a stage instead of a scalar:
#   S1-S4  the paper's OptCC stages (reduce-scatter chain, upload to the
#          straggler, download from the straggler, allgather); the multi-
#          straggler schedule reuses them per its ordering-B flavour
#          (uploads = S3, ring = S1, allgather = S4, downloads = S2);
#   RS/AG  plain ring reduce-scatter / allgather rounds;
#   SELF   zero-size local bookkeeping flows (never wire traffic);
#   STAR   Appendix-C star flows where they are separate wire transfers
#          (legacy generator; the slotted construction merges them into
#          S2/S3);
#   N1-N4  the multi-GPU NVLink phases (collect healthy / distribute
#          straggler / collect straggler / distribute healthy).
# Stage ids live in ``Schedule.meta["stage_ids"]`` (int16 array indexed by
# fid) - metadata only, never consulted by the simulator's timing paths.
STAGE_NAMES = ("S1", "S2", "S3", "S4", "RS", "AG", "SELF", "STAR",
               "N1", "N2", "N3", "N4")
STAGE_ID = {name: i for i, name in enumerate(STAGE_NAMES)}


class Op(enum.Enum):
    """What the receiver does with an incoming flow's payload.

    Sender semantics are uniform: a flow sends ``bufs[src][key]`` if that
    buffer exists, else the sender's raw input slice ``x[src][lo:hi]``
    (chain starts / ordering-B straggler uploads).
    """

    # bufs[dst][key] = (bufs[dst][key] if present else x[dst][lo:hi]) + payload
    # Init-once-with-own-contribution + order-independent accumulation: this
    # single primitive expresses ring reduce-scatter hops, straggler uploads,
    # multi-straggler owner combines, NVLink collects and star reduces.
    ACCUM = "accum"
    # out[dst][lo:hi] = payload; bufs[dst][key] = payload (store & forward:
    # allgather hops, straggler downloads, NVLink distributes).
    STORE = "store"


@dataclasses.dataclass(frozen=True)
class Flow:
    """One point-to-point transfer.

    Attributes:
      fid: unique id (also the priority: lower fid = earlier in schedule order).
      src/dst: GPU ranks.
      size: number of elements (float allowed; fractional sections appear in
        bubble filling where s' is generally non-integral in element-time units).
      deps: fids that must complete before this flow may start.
      lo/hi: element range [lo, hi) of the vector this flow carries.
      op: receiver semantics (see Op).
      key: opaque tuple used by the executor to name partial-sum buffers.
      pri: planned start time in the paper's slotted timeline (Figures 5-6).
        The simulator uses it as the dispatch priority (work-conserving: a
        flow may still start early if ports are free). None -> fid order.
    """

    fid: int
    src: int
    dst: int
    size: float
    deps: tuple[int, ...]
    lo: float = 0.0
    hi: float = 0.0
    op: Op = Op.STORE
    key: tuple = ()
    pri: Optional[float] = None
    release: float = 0.0   # hard earliest-start time (slotted schedules)
    # Extra payload parts packed into the same wire transfer (Appendix C:
    # bubble filling *enlarges* Stage-2/3 flows to carry the P2P star chunk).
    # Each entry is (lo, hi, op, key); `size` covers main + extras.
    extra: tuple = ()

    @property
    def priority(self) -> tuple[float, int]:
        return (self.pri if self.pri is not None else float(self.fid),
                self.fid)


@dataclasses.dataclass(frozen=True)
class BandwidthProfile:
    """Per-rank NIC slowdown factors. slowdown[i] == 1.0 means healthy.

    For the multi-GPU/server setting, `gpus_per_server` > 1 and ranks are
    grouped server-major: server j owns ranks [j*g, (j+1)*g). NVLink rate is
    (g-1)x the NIC rate per the paper's provisioning assumption.
    """

    p: int
    slowdown: tuple[float, ...]
    gpus_per_server: int = 1
    # NVLink per-direction bandwidth as a multiple of one NIC. None ->
    # the paper's provisioning assumption (g-1)x, the *minimum* that hides
    # intra-server traffic. Real hardware has more headroom (DGX A100:
    # 2400 Gbps NVLink vs 200 Gbps NIC = 12x; paper footnote 4).
    nvlink_mult: float | None = None

    @property
    def nvlink_rate(self) -> float:
        if self.nvlink_mult is not None:
            return self.nvlink_mult
        return max(self.gpus_per_server - 1, 1)

    def __post_init__(self):
        if len(self.slowdown) != self.p:
            raise ValueError(f"slowdown must have length p={self.p}")
        if any(l < 1.0 for l in self.slowdown):
            raise ValueError("slowdown factors must be >= 1")
        if self.p % self.gpus_per_server:
            raise ValueError("p must be divisible by gpus_per_server")

    @classmethod
    def healthy(cls, p: int, g: int = 1) -> "BandwidthProfile":
        return cls(p=p, slowdown=(1.0,) * p, gpus_per_server=g)

    @classmethod
    def single_straggler(cls, p: int, ell: float, straggler: int = 0,
                         g: int = 1) -> "BandwidthProfile":
        sl = [1.0] * p
        if g == 1:
            sl[straggler] = ell
        else:
            # straggler is a *server* index; all its GPUs' NICs degrade (PXN).
            for r in range(straggler * g, (straggler + 1) * g):
                sl[r] = ell
        return cls(p=p, slowdown=tuple(sl), gpus_per_server=g)

    @classmethod
    def multi_straggler(cls, p: int, ells: Sequence[float],
                        stragglers: Optional[Sequence[int]] = None
                        ) -> "BandwidthProfile":
        if stragglers is None:
            stragglers = list(range(len(ells)))
        sl = [1.0] * p
        for r, l in zip(stragglers, ells):
            sl[r] = l
        return cls(p=p, slowdown=tuple(sl))

    @property
    def stragglers(self) -> tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.slowdown) if l > 1.0)

    @property
    def max_ell(self) -> float:
        return max(self.slowdown)

    @property
    def num_servers(self) -> int:
        return self.p // self.gpus_per_server


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One rate change: from time ``t`` on, ``rank``'s NIC slowdown is
    ``ell`` (absolute, not a delta; ``ell == 1.0`` means fully recovered).

    Times are in element-time units of the flow model, the same clock the
    simulator runs on. Events at ``t == 0`` rewrite the initial profile
    (a recovery at t=0 on a degraded base is exactly the healthy cluster).
    """

    t: float
    rank: int
    ell: float

    def __post_init__(self):
        if not (self.t >= 0.0 and self.t == self.t and self.t != float("inf")):
            raise ValueError(f"event time must be finite and >= 0, got {self.t}")
        if self.ell < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {self.ell}")
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {self.rank}")


@dataclasses.dataclass(frozen=True)
class FaultTimeline:
    """A failure timeline: piecewise-constant per-rank slowdowns layered on a
    BandwidthProfile. Real clusters degrade *over time* - NICs flap, traffic
    reroutes, links recover mid-collective (the R2CCL failure catalogs, the
    Alibaba-GPU-2020 / AcmeTrace fault traces) - and a static profile cannot
    express that. The timeline is the additive piece: the base profile gives
    the slowdown vector at t=0 and each event rewrites one rank's rate from
    its time on. Only NIC rates vary; NVLink is never degraded (same
    assumption as the static model).

    Events are kept sorted by (t, rank, insertion order); later events on the
    same rank win. The timeline itself is profile-agnostic - `segments`
    resolves it against a concrete base profile into breakpoints + per-segment
    slowdown vectors, skipping no-op changes so a timeline that never alters
    the effective vector has no breakpoints at all (and the simulator then
    takes the static path, bit-for-bit).
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        evs = tuple(self.events)
        if any(not isinstance(e, FaultEvent) for e in evs):
            raise TypeError("events must be FaultEvent instances; "
                            "use FaultTimeline.make for (t, rank, ell) tuples")
        order = sorted(range(len(evs)), key=lambda i: (evs[i].t, evs[i].rank, i))
        object.__setattr__(self, "events", tuple(evs[i] for i in order))

    @classmethod
    def make(cls, events: Sequence) -> "FaultTimeline":
        """Build from an iterable of FaultEvent or (t, rank, ell) tuples."""
        return cls(tuple(e if isinstance(e, FaultEvent) else FaultEvent(*e)
                         for e in events))

    def slowdown_at(self, profile: "BandwidthProfile",
                    t: float) -> tuple[float, ...]:
        """Effective slowdown vector at time t (events with ``e.t <= t``
        applied to the base profile, in order)."""
        sl = list(profile.slowdown)
        for e in self.events:
            if e.t > t:
                break
            if e.rank >= profile.p:
                raise ValueError(f"event rank {e.rank} >= p={profile.p}")
            sl[e.rank] = e.ell
        return tuple(sl)

    def profile_at(self, profile: "BandwidthProfile",
                   t: float) -> "BandwidthProfile":
        """The static BandwidthProfile in effect at time t."""
        return dataclasses.replace(profile, slowdown=self.slowdown_at(profile, t))

    def segments(self, profile: "BandwidthProfile"
                 ) -> tuple[tuple[float, ...], tuple[tuple[float, ...], ...]]:
        """Resolve against a base profile: (breakpoints, vectors).

        breakpoints are strictly increasing times > 0 at which the effective
        slowdown vector *changes value*; vectors[j] is the slowdown tuple in
        force on [breakpoints[j-1], breakpoints[j]) (vectors[0] from t=0,
        already including any t=0 events). len(vectors) == len(breaks) + 1.
        No-op events (rewriting a rank to its current value) produce no
        breakpoint, so a constant timeline resolves to ([], [initial]).
        """
        sl = list(profile.slowdown)
        for e in self.events:
            if e.rank >= profile.p:
                raise ValueError(f"event rank {e.rank} >= p={profile.p}")
        i = 0
        evs = self.events
        while i < len(evs) and evs[i].t <= 0.0:
            sl[evs[i].rank] = evs[i].ell
            i += 1
        breaks: list[float] = []
        vectors: list[tuple[float, ...]] = [tuple(sl)]
        while i < len(evs):
            t = evs[i].t
            while i < len(evs) and evs[i].t == t:
                sl[evs[i].rank] = evs[i].ell
                i += 1
            vec = tuple(sl)
            if vec != vectors[-1]:
                breaks.append(t)
                vectors.append(vec)
        return tuple(breaks), tuple(vectors)

    def is_constant(self, profile: "BandwidthProfile") -> bool:
        """True when the effective slowdown vector never changes after t=0
        (the simulator then reduces to the static profile_at(0) run)."""
        return not self.segments(profile)[0]

    def after(self, t0: float) -> "FaultTimeline":
        """The residual timeline seen by a plan launched at absolute time t0:
        events at or before t0 are dropped (fold them into the launch profile
        via `profile_at`), later ones shift to the plan's local clock."""
        return FaultTimeline(tuple(
            FaultEvent(e.t - t0, e.rank, e.ell)
            for e in self.events if e.t > t0))

    def changes(self, profile: "BandwidthProfile"
                ) -> dict[int, list[tuple[float, float]]]:
        """Per-rank effective value changes after t=0, resolved against the
        base profile: {rank: [(t, new_ell), ...]} with strictly increasing
        t per rank. No-op events are dropped (same semantics as `segments`);
        ranks that never change are absent. This is the per-rank view the
        fault-detection layer (`repro_torch.detect`) samples through its probe
        lens, and what `comms.fault.FailureInjector.to_timeline` round-trips
        through in tests."""
        breaks, vectors = self.segments(profile)
        out: dict[int, list[tuple[float, float]]] = {}
        for j, t in enumerate(breaks):
            prev, cur = vectors[j], vectors[j + 1]
            for r in range(profile.p):
                if cur[r] != prev[r]:
                    out.setdefault(r, []).append((t, cur[r]))
        return out

    def min_profile(self, profile: "BandwidthProfile") -> "BandwidthProfile":
        """Per-rank best-ever rates over the whole timeline: the static
        profile in which every NIC always runs at the fastest rate it ever
        reaches. Any run under the timeline is pointwise no faster than the
        same run under this profile (rates only get better), so its static
        lower bound is a valid bound for the time-varying run."""
        _, vectors = self.segments(profile)
        best = [min(vec[r] for vec in vectors) for r in range(profile.p)]
        return dataclasses.replace(profile, slowdown=tuple(best))


@dataclasses.dataclass
class Schedule:
    """A complete flow schedule plus NVLink flows (multi-GPU setting).

    nic_flows are timed against NIC ports; nvlink_flows against per-GPU
    NVLink ports at rate (g-1)x NIC speed. For g == 1, nvlink_flows is empty.

    Every generator stamps a `meta` dict honoring the key contract below
    (`validate_schedule_meta`); extra generator-specific keys are fine.

      algo       str, the concrete construction ("ring", "optcc-single",
                 "optcc-multi", "optcc-multigpu", "hierarchical", "dbtree",
                 "torus2d"). What `Plan.algo` and sweep artifacts report.
      topology   str, the schedule-registry name the construction belongs
                 to (`planner.topology_of(algo)`): the optcc-* variants all
                 map to "optcc". What `make_plan(algo=...)` accepts.
      stage_ids  int array of len == num_flows mapping each flow (by fid)
                 to its pipeline stage in STAGE_NAMES, for telemetry
                 attribution (repro_torch.obs).
    """

    profile: BandwidthProfile
    n: float                      # total vector length (elements)
    nic_flows: list[Flow]
    nvlink_flows: list[Flow] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)
    # Columnar flow graph (core.flowvec.FlowArrays) built by the vectorized
    # generators. When set, nic_flows/nvlink_flows may be empty: the sweep
    # hot path simulates straight from the arrays and never pays for Flow
    # object construction. Schedules that need per-flow semantics (executor,
    # correctness tests) are generated with materialize=True instead.
    arrays: object = None

    @property
    def num_flows(self) -> int:
        if self.arrays is not None:
            return self.arrays.nflows
        return len(self.nic_flows) + len(self.nvlink_flows)


def validate_schedule_meta(schedule: Schedule) -> None:
    """Assert `schedule.meta` honors the documented key contract (Schedule
    docstring): non-empty `algo`/`topology` strings and a full-length
    `stage_ids` vector with in-range stage indices. `simulate` runs this in
    debug mode (REPRO_DEBUG=1) so a generator that forgets a key fails the
    first simulation, not a sweep artifact check three layers up."""
    meta = schedule.meta
    for key in ("algo", "topology"):
        val = meta.get(key)
        if not (isinstance(val, str) and val):
            raise ValueError(
                f"schedule.meta[{key!r}] must be a non-empty str, got "
                f"{val!r} (algo={meta.get('algo')!r})")
    stage_ids = meta.get("stage_ids")
    if stage_ids is None:
        raise ValueError(
            f"schedule.meta['stage_ids'] missing (algo={meta['algo']!r})")
    import numpy as np
    sids = np.asarray(stage_ids)
    if sids.shape != (schedule.num_flows,):
        raise ValueError(
            f"stage_ids has shape {sids.shape}, expected "
            f"({schedule.num_flows},) (algo={meta['algo']!r})")
    if sids.size and (sids.min() < 0 or sids.max() >= len(STAGE_NAMES)):
        raise ValueError(
            f"stage_ids values outside [0, {len(STAGE_NAMES)}) "
            f"(algo={meta['algo']!r})")
