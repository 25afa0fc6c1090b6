"""Fault-scenario grids for the sweep engine.

A ScenarioSpec is a fully-resolved, hashable description of one AllReduce
under one degradation pattern: cluster shape (p, g), pipeline depth k, vector
length n, and the per-rank slowdown vector. The generators below expand the
paper's four hand-picked figures into thousands of scenarios across five
families:

  healthy     - no degradation (ring baseline sanity / T0 calibration);
  single      - one straggler NIC, swept over p, ell and straggler position;
  multi       - m >= 2 stragglers with heterogeneous ell vectors and
                scattered placements (Appendix D's regime);
  multigpu    - g GPUs/server, one degraded server (PXN pools every GPU on
                the server through the slow NICs), both NVLink provisionings;
  correlated  - multigpu where the whole server is degraded hard (the
                "correlated server fault" case: ToR/egress loss hits every
                NIC on the box at once, ell drawn at the high end);
  replay      - time-varying failure timelines (NIC flaps, reroutes,
                recoveries) replayed through the simulator with mid-flight
                re-planning, from deterministic trace-shaped generators
                modeled on the Alibaba-GPU-2020 / AcmeTrace fault catalogs
                (PAPERS.md) plus miniature checked-in traces in ci/traces/;
  topology    - the registry schedules beyond ring/optcc (hierarchical,
                dbtree, torus2d) under healthy and degraded profiles, each
                scored against its own per-topology lower bound and against
                whatever `make_plan(algo="auto")` would have planned.

Grids are deterministic: the same (profile, seed) always yields the same
scenario list, which is what makes the sweep artifact reproducible and
diffable in CI. Randomized placements/ells use an explicit random.Random(seed)
stream, never global randomness.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Iterator, Optional, Sequence

from repro_torch.core.model import BandwidthProfile

# ell values the paper sweeps (fractions of NIC bandwidth retained:
# 7/8, 3/4, 5/8, 1/2, 3/8, 1/4).
PAPER_ELLS = (8 / 7, 4 / 3, 1.6, 2.0, 8 / 3, 4.0)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One point of a sweep grid. Frozen + tuple-valued so specs can be
    hashed, deduplicated, and pickled to worker processes."""

    name: str
    family: str           # healthy|single|multi|multigpu|correlated|replay
    p: int
    n: int
    k: int
    slowdown: tuple[float, ...]
    gpus_per_server: int = 1
    nvlink_mult: Optional[float] = None
    fill_bubbles: bool = True
    simulate_ring: bool = True        # also time the degraded ring (ICCL)
    # Failure timeline as (t, rank, ell) triples; t in units of the
    # scenario's fault-free optimum T0 so trace files are scale-free (the
    # engine multiplies by t0_fault_free(p, n, g) at run time). Empty =
    # static scenario. Tuple-of-tuples keeps the spec hashable.
    events: tuple[tuple[float, int, float], ...] = ()
    # Imperfect-detection config as sorted (key, value) pairs (hashable);
    # empty = the PR-8 zero-delay oracle controller (the replay family).
    # Keys mirror repro_torch.detect.DetectorConfig / ControllerConfig; the
    # time-valued ones (probe_interval, latency, backoff_base) are in T0
    # units like `events` and are rescaled by the engine.
    detection: tuple[tuple[str, object], ...] = ()
    # Schedule-registry algorithm to plan ("auto" = the planner's OptCC-vs-
    # ring choice, the historical behavior). Non-"auto" scenarios (the
    # topology family) are additionally scored against the auto plan.
    algo: str = "auto"

    @property
    def policy(self) -> Optional[str]:
        """Controller policy for detection scenarios, else None."""
        d = dict(self.detection)
        return str(d["policy"]) if "policy" in d else None

    def profile(self) -> BandwidthProfile:
        return BandwidthProfile(p=self.p, slowdown=self.slowdown,
                                gpus_per_server=self.gpus_per_server,
                                nvlink_mult=self.nvlink_mult)

    @property
    def stragglers(self) -> tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.slowdown) if l > 1.0)

    @property
    def max_ell(self) -> float:
        return max(self.slowdown)


def _slowdown(p: int, placed: dict[int, float]) -> tuple[float, ...]:
    sl = [1.0] * p
    for r, l in placed.items():
        sl[r] = l
    return tuple(sl)


def _seg_n(p: int, k: int, g: int = 1, unit: int = 16) -> int:
    """Vector length giving `unit` elements per (segment, section): keeps the
    flow count (and thus sweep wall time) proportional to p*k, independent of
    message size. Element-time is linear in n, so overhead ratios are
    n-invariant."""
    return g * k * max(p // g - 1, 1) * unit


# ----------------------------------------------------------------------------
# family generators
# ----------------------------------------------------------------------------

def gen_healthy(ps: Sequence[int], ks: Sequence[int]) -> Iterator[ScenarioSpec]:
    for p in ps:
        for k in ks:
            yield ScenarioSpec(name=f"healthy_p{p}_k{k}", family="healthy",
                               p=p, n=_seg_n(p, k), k=k,
                               slowdown=(1.0,) * p)


def gen_single(ps: Sequence[int], ks: Sequence[int],
               ells: Sequence[float] = PAPER_ELLS,
               positions: Sequence[float] = (0.0, 0.5)) -> Iterator[ScenarioSpec]:
    """Single straggler: sweep size, depth, severity and straggler position
    (positions are fractions of p; OptCC must be position-invariant)."""
    for p in ps:
        for k in ks:
            for ell in ells:
                for frac in positions:
                    pos = min(int(frac * p), p - 1)
                    yield ScenarioSpec(
                        name=f"single_p{p}_k{k}_l{ell:.3f}_r{pos}",
                        family="single", p=p, n=_seg_n(p, k), k=k,
                        slowdown=_slowdown(p, {pos: ell}))


def gen_multi(ps: Sequence[int], ks: Sequence[int],
              ell_sets: Sequence[tuple[float, ...]],
              rng: random.Random) -> Iterator[ScenarioSpec]:
    """m >= 2 stragglers with heterogeneous severities; placements drawn from
    the seeded stream (adjacent, spread, and random placements all occur)."""
    for p in ps:
        for k in ks:
            for ells in ell_sets:
                m = len(ells)
                if m >= p - 1:
                    continue
                placements = {
                    "adj": list(range(m)),
                    "spread": [(i * p) // m for i in range(m)],
                    "rand": sorted(rng.sample(range(p), m)),
                }
                for ptag, ranks in placements.items():
                    if len(set(ranks)) != m:
                        continue
                    ltag = "-".join(f"{l:.2f}" for l in ells)
                    yield ScenarioSpec(
                        name=f"multi_p{p}_k{k}_l{ltag}_{ptag}",
                        family="multi", p=p, n=_seg_n(p, k), k=k,
                        slowdown=_slowdown(p, dict(zip(ranks, ells))))


def gen_multigpu(gs: Sequence[int], qs: Sequence[int], ks: Sequence[int],
                 ells: Sequence[float],
                 nvlink_mults: Sequence[Optional[float]] = (None, 12.0),
                 family: str = "multigpu") -> Iterator[ScenarioSpec]:
    """One degraded server with g GPUs behind its NIC pool. `correlated` is
    the same topology tagged separately and driven at high ell (whole-box
    ToR/egress faults rather than a single flaky NIC)."""
    for g in gs:
        for q in qs:
            p = g * q
            for k in ks:
                for ell in ells:
                    for nv in nvlink_mults:
                        nvtag = "nvmin" if nv is None else f"nv{nv:g}"
                        sl = {r: ell for r in range(g)}  # server 0 degraded
                        yield ScenarioSpec(
                            name=f"{family}_g{g}_q{q}_k{k}_l{ell:.3f}_{nvtag}",
                            family=family, p=p, n=_seg_n(p, k, g), k=k,
                            slowdown=_slowdown(p, sl), gpus_per_server=g,
                            nvlink_mult=nv,
                            # Degraded-ring baseline is meaningful but slow to
                            # simulate with NVLink phases; keep it for the
                            # smoke-sized grids only (q <= 8).
                            simulate_ring=(q <= 8))


def gen_random_single_multi(count: int, ps: Sequence[int],
                            ks: Sequence[int],
                            rng: random.Random) -> Iterator[ScenarioSpec]:
    """Fill the tail of the grid with randomized-but-reproducible scenarios:
    m in [1, 4] stragglers, ell in [1.28, 4], random placement. These catch
    regime boundaries the hand grids skip (ell just under 2, near-coincident
    stragglers, m close to p/2)."""
    for i in range(count):
        p = rng.choice(list(ps))
        k = rng.choice(list(ks))
        m = rng.randint(1, min(4, p // 2 - 1))
        ranks = rng.sample(range(p), m)
        placed = {}
        for r in ranks:
            # Bandwidth retained uniform in [1/4, 3/4] -> ell in [4/3, 4].
            # The floor keeps the tail inside the regime where OptCC
            # dominates the degraded ring at smoke-grid pipeline depths
            # (below ell ~1.45 at k=12 the ring's convoy-effect jitter makes
            # the head-to-head comparison noisy in isolated ell pockets; the
            # hand grids still cover ell = 8/7 and 4/3 there).
            retained = rng.uniform(0.25, 0.75)
            placed[r] = 1.0 / retained
        family = "single" if m == 1 else "multi"
        yield ScenarioSpec(
            name=f"rand{i:04d}_p{p}_k{k}_m{m}",
            family=family, p=p, n=_seg_n(p, k), k=k,
            slowdown=_slowdown(p, placed))


# ----------------------------------------------------------------------------
# replay family: time-varying failure timelines
# ----------------------------------------------------------------------------
#
# Event times are in units of the scenario's fault-free optimum T0 (the
# engine rescales), so the same trace shape is meaningful at every (p, n, k).
# Shapes are modeled on what the public GPU-cluster fault catalogs show
# (Alibaba-GPU-2020, AcmeTrace/Kalos; see the R2CCL entry in PAPERS.md):
# NIC/link flaps that clear within the collective, reroutes that move the
# congestion to another rank, and mid-collective recoveries of a straggler
# that was present at launch.

def gen_replay_recovery(ps: Sequence[int], ks: Sequence[int],
                        ells: Sequence[float] = (2.0, 4.0),
                        rec_fracs: Sequence[float] = (0.25, 0.5)
                        ) -> Iterator[ScenarioSpec]:
    """Straggler present at t=0 recovers mid-collective. The no-replan
    schedule keeps pacing itself for the vanished straggler (slotted release
    times), so these are the scenarios where mid-flight re-planning wins."""
    for p in ps:
        for k in ks:
            for ell in ells:
                for frac in rec_fracs:
                    yield ScenarioSpec(
                        name=f"replay_recovery_p{p}_k{k}_l{ell:.3f}_t{frac:g}",
                        family="replay", p=p, n=_seg_n(p, k), k=k,
                        slowdown=(1.0,) * p, simulate_ring=False,
                        events=((0.0, 0, ell), (frac, 0, 1.0)))


def gen_replay_flap(ps: Sequence[int], ks: Sequence[int],
                    ells: Sequence[float] = (2.0, 8 / 3)
                    ) -> Iterator[ScenarioSpec]:
    """Healthy launch; one NIC flaps down/up twice mid-collective (the
    transient-congestion shape OptiReduce attributes the p99 tail to)."""
    for p in ps:
        for k in ks:
            for ell in ells:
                r = p // 2
                yield ScenarioSpec(
                    name=f"replay_flap_p{p}_k{k}_l{ell:.3f}",
                    family="replay", p=p, n=_seg_n(p, k), k=k,
                    slowdown=(1.0,) * p, simulate_ring=False,
                    events=((0.15, r, ell), (0.35, r, 1.0),
                            (0.55, r, ell), (0.75, r, 1.0)))


def gen_replay_reroute(ps: Sequence[int], ks: Sequence[int],
                       ells: Sequence[float] = (2.0,)
                       ) -> Iterator[ScenarioSpec]:
    """Congestion moves: the launch straggler clears but the rerouted
    traffic degrades a different rank at the same instant."""
    for p in ps:
        for k in ks:
            for ell in ells:
                b = p // 2
                yield ScenarioSpec(
                    name=f"replay_reroute_p{p}_k{k}_l{ell:.3f}",
                    family="replay", p=p, n=_seg_n(p, k), k=k,
                    slowdown=(1.0,) * p, simulate_ring=False,
                    events=((0.0, 0, ell), (0.4, 0, 1.0), (0.4, b, ell)))


def gen_replay_const(ps: Sequence[int], ks: Sequence[int],
                     ells: Sequence[float] = (2.0,)
                     ) -> Iterator[ScenarioSpec]:
    """Constant timelines: the only event is at t=0, so the replay must be
    IEEE-754-identical to its static single-straggler twin (same p/n/k,
    straggler at rank 0) - the JAX package's replay tests pin exactly that
    against the artifact."""
    for p in ps:
        for k in ks:
            for ell in ells:
                yield ScenarioSpec(
                    name=f"replay_const_p{p}_k{k}_l{ell:.3f}",
                    family="replay", p=p, n=_seg_n(p, k), k=k,
                    slowdown=(1.0,) * p, simulate_ring=False,
                    events=((0.0, 0, ell),))


# Checked-in miniature traces (ci/traces/*.json). Times in T0 units, ranks
# taken modulo p at expansion time. Resolution order: $REPRO_TRACES_DIR,
# then the repo-relative ci/traces next to the src/ layout.
_REPO_TRACES = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "ci", "traces"))


def traces_dir() -> str:
    return os.environ.get("REPRO_TRACES_DIR", _REPO_TRACES)


def load_trace(path: str) -> dict:
    """Load + validate one trace file: {"name", "events": [[t, rank, ell]...],
    optional "description"/"source"}. Raises ValueError on malformed files -
    a trace that silently loads as empty would weaken the CI gate."""
    with open(path) as f:
        obj = json.load(f)
    name = obj.get("name")
    events = obj.get("events")
    if not isinstance(name, str) or not name:
        raise ValueError(f"{path}: trace needs a non-empty string 'name'")
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path}: trace needs a non-empty 'events' list")
    for i, e in enumerate(events):
        if (not isinstance(e, list) or len(e) != 3
                or not all(isinstance(x, (int, float)) for x in e)):
            raise ValueError(f"{path}: events[{i}] must be [t, rank, ell]")
        t, rank, ell = e
        if t < 0 or ell < 1.0 or int(rank) != rank or rank < 0:
            raise ValueError(f"{path}: events[{i}] out of range: {e}")
    return obj


def gen_replay_traces(ps: Sequence[int], ks: Sequence[int],
                      directory: Optional[str] = None
                      ) -> Iterator[ScenarioSpec]:
    """One scenario per (checked-in trace, p, k). Missing directory yields
    nothing (the grid stays valid outside a repo checkout); malformed trace
    files raise."""
    d = traces_dir() if directory is None else directory
    if not os.path.isdir(d):
        return
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        tr = load_trace(os.path.join(d, fname))
        for p in ps:
            for k in ks:
                events = tuple((float(t), int(rank) % p, float(ell))
                               for t, rank, ell in tr["events"])
                yield ScenarioSpec(
                    name=f"replay_trace_{tr['name']}_p{p}_k{k}",
                    family="replay", p=p, n=_seg_n(p, k), k=k,
                    slowdown=(1.0,) * p, simulate_ring=False,
                    events=events)


def gen_replay(ps: Sequence[int], ks: Sequence[int],
               ells: Sequence[float] = (2.0, 4.0)) -> list[ScenarioSpec]:
    """The whole replay family for a (ps, ks) block: generator shapes plus
    every checked-in trace."""
    specs: list[ScenarioSpec] = []
    specs += gen_replay_recovery(ps, ks, ells=ells)
    specs += gen_replay_flap(ps, ks)
    specs += gen_replay_reroute(ps, ks)
    specs += gen_replay_const(ps, ks)
    specs += gen_replay_traces(ps, ks)
    return specs


# ----------------------------------------------------------------------------
# detection family: imperfect detectors + controller policies
# ----------------------------------------------------------------------------
#
# Each scenario replays one of the checked-in fault traces (the flap /
# recovery / reroute-cascade shapes) through an *imperfect* detector -
# probe cadence x estimation noise x FP/FN rates - under one controller
# policy (immediate / debounce / backoff), and is scored against the PR-8
# zero-delay oracle on the same trace (`overhead_vs_oracle`). Falls back to
# the equivalent generator shapes when ci/traces is absent (a grid built
# outside a repo checkout must still carry the family - it is CI-gated).

# (name, events) fallbacks mirroring ci/traces/*.json shapes.
_DETECTION_FALLBACK_BASES = (
    ("nic_flap", ((0.1, 3, 2.0), (0.22, 3, 1.0), (0.4, 3, 2.0),
                  (0.48, 3, 1.0), (0.66, 3, 1.6), (0.8, 3, 1.0))),
    ("reroute_cascade", ((0.0, 0, 8 / 3), (0.3, 0, 1.0), (0.3, 2, 1.6),
                         (0.3, 5, 1.6), (0.7, 2, 1.0), (0.7, 5, 1.0))),
    ("straggler_recovery", ((0.0, 1, 4.0), (0.35, 1, 1.0))),
)


def _detection_bases(p: int) -> list[tuple[str, tuple]]:
    """(name, events) per checked-in trace, ranks wrapped modulo p."""
    d = traces_dir()
    if not os.path.isdir(d):
        bases = list(_DETECTION_FALLBACK_BASES)
    else:
        bases = []
        for fname in sorted(os.listdir(d)):
            if fname.endswith(".json"):
                tr = load_trace(os.path.join(d, fname))
                bases.append((tr["name"], tuple(
                    (float(t), int(r), float(l)) for t, r, l in tr["events"])))
    return [(name, tuple((t, r % p, l) for t, r, l in events))
            for name, events in bases]


def gen_detection(ps: Sequence[int], ks: Sequence[int],
                  probe_intervals: Sequence[float] = (0.02, 0.06),
                  noises: Sequence[float] = (0.0, 0.15),
                  fpfns: Sequence[tuple[float, float]] = ((0.0, 0.0),
                                                          (0.02, 0.05)),
                  policies: Sequence[str] = ("immediate", "debounce",
                                             "backoff"),
                  latency: float = 0.01,
                  quant: float = 0.25) -> Iterator[ScenarioSpec]:
    """Detection grid: traces x probe interval x noise x (FP, FN) x policy.

    All detector times are in T0 units (scale-free, like trace events).
    Each detector combo gets its own deterministic seed so FP/FN draws
    differ across combos but never across runs."""
    for p in ps:
        bases = _detection_bases(p)
        for k in ks:
            for name, events in bases:
                combo = 0
                for pi in probe_intervals:
                    for nz in noises:
                        for fp, fn in fpfns:
                            combo += 1
                            for policy in policies:
                                det = (
                                    ("fn_rate", fn),
                                    ("fp_rate", fp),
                                    ("latency", latency),
                                    ("noise", nz),
                                    ("policy", policy),
                                    ("probe_interval", pi),
                                    ("quant", quant),
                                    ("seed", combo),
                                )
                                yield ScenarioSpec(
                                    name=(f"detect_{name}_p{p}_k{k}"
                                          f"_pi{pi:g}_nz{nz:g}_fp{fp:g}"
                                          f"_fn{fn:g}_{policy}"),
                                    family="detection", p=p,
                                    n=_seg_n(p, k), k=k,
                                    slowdown=(1.0,) * p,
                                    simulate_ring=False,
                                    events=events, detection=det)


def gen_topology(ps: Sequence[int] = (8, 16), ks: Sequence[int] = (12,),
                 ells: Sequence[float] = (1.6, 2.0, 4.0),
                 hier_gs: Sequence[int] = (2, 4),
                 hier_qs: Sequence[int] = (4, 8),
                 hier_ells: Sequence[float] = (2.0, 4.0)
                 ) -> Iterator[ScenarioSpec]:
    """Topology family: every registry schedule beyond ring/optcc, under
    healthy and straggler profiles. dbtree/torus2d run on flat (g=1)
    clusters with a mid-ring straggler; hierarchical runs on multi-GPU
    servers with server 0 degraded (PXN: all its NICs slow). The engine
    also plans `algo="auto"` on the same profile, so each scenario is
    scored both against its own lower bound (optcc_vs_lb) and against the
    planner's choice (overhead_vs_auto). Fully deterministic - no rng."""
    for algo in ("dbtree", "torus2d"):
        for p in ps:
            for k in ks:
                n = _seg_n(p, k)
                yield ScenarioSpec(name=f"topo_{algo}_healthy_p{p}_k{k}",
                                   family="topology", p=p, n=n, k=k,
                                   slowdown=(1.0,) * p,
                                   simulate_ring=False, algo=algo)
                for ell in ells:
                    yield ScenarioSpec(
                        name=f"topo_{algo}_single_p{p}_k{k}_l{ell:g}",
                        family="topology", p=p, n=n, k=k,
                        slowdown=_slowdown(p, {p // 2: ell}),
                        simulate_ring=False, algo=algo)
    for g in hier_gs:
        for q in hier_qs:
            p = g * q
            for k in ks:
                n = _seg_n(p, k, g)
                yield ScenarioSpec(
                    name=f"topo_hier_healthy_g{g}_q{q}_k{k}",
                    family="topology", p=p, n=n, k=k,
                    slowdown=(1.0,) * p, gpus_per_server=g,
                    simulate_ring=False, algo="hierarchical")
                for ell in hier_ells:
                    yield ScenarioSpec(
                        name=f"topo_hier_g{g}_q{q}_k{k}_l{ell:g}",
                        family="topology", p=p, n=n, k=k,
                        slowdown=_slowdown(p, {r: ell for r in range(g)}),
                        gpus_per_server=g,
                        simulate_ring=False, algo="hierarchical")


# ----------------------------------------------------------------------------
# named grids
# ----------------------------------------------------------------------------

def smoke_grid(seed: int = 0) -> list[ScenarioSpec]:
    """CI-sized: >= 200 scenarios, seconds of CPU. Small p; k deep enough
    (>= 12) to amortize pipeline fill, so the paper's OptCC-beats-degraded-
    ring claim holds on every ell <= 2 scenario (tests/test_torch_sweeps.py
    gates on exactly that). The shallow-k fill-cost regime lives in full_grid."""
    rng = random.Random(seed)
    specs: list[ScenarioSpec] = []
    specs += gen_healthy(ps=(4, 8, 16), ks=(12, 16))
    specs += gen_single(ps=(4, 8, 16), ks=(12, 16))
    specs += gen_multi(
        ps=(8, 16), ks=(12,),
        ell_sets=((4 / 3, 8 / 7), (2.0, 4 / 3), (2.0, 2.0),
                  (8 / 3, 1.6, 8 / 7)),
        rng=rng)
    specs += gen_multigpu(gs=(2, 4), qs=(4, 8), ks=(12,),
                          ells=(8 / 7, 2.0))
    specs += gen_multigpu(gs=(2, 4), qs=(4,), ks=(12,),
                          ells=(8 / 3, 4.0), nvlink_mults=(12.0,),
                          family="correlated")
    specs += gen_random_single_multi(count=96, ps=(8, 12, 16), ks=(16,),
                                     rng=rng)
    specs += gen_replay(ps=(8, 16), ks=(12,))
    specs += gen_detection(ps=(8,), ks=(12,))
    specs += gen_topology()
    return _dedup(specs)


def full_grid(seed: int = 0) -> list[ScenarioSpec]:
    """Nightly-sized: thousands of scenarios up to p=64 at every depth, plus
    a paper-scale p=1024 block (Section 4.3 runs at p=1024; the vectorized
    generator + simulator make ~8M-flow scenarios minutes, not hours)."""
    rng = random.Random(seed)
    specs: list[ScenarioSpec] = []
    specs += gen_healthy(ps=(4, 8, 16, 32, 64), ks=(4, 16, 32))
    specs += gen_single(ps=(4, 8, 16, 32, 64), ks=(4, 16, 32),
                        positions=(0.0, 0.25, 0.5))
    # Paper-scale block: p=256 and p=1024 single stragglers. One straggler
    # position (OptCC is position-invariant; the small-p blocks above sweep
    # positions) and shallow k to keep flow counts ~p^2 k bounded.
    specs += gen_healthy(ps=(256, 1024), ks=(4,))
    specs += gen_single(ps=(256, 1024), ks=(4,),
                        ells=(8 / 7, 2.0, 4.0), positions=(0.5,))
    specs += gen_multi(
        ps=(8, 16, 32, 64), ks=(4, 16),
        ell_sets=((4 / 3, 8 / 7), (2.0, 4 / 3), (2.0, 2.0), (4.0, 2.0),
                  (8 / 3, 1.6, 8 / 7), (2.0, 2.0, 2.0, 2.0)),
        rng=rng)
    specs += gen_multigpu(gs=(2, 4, 8), qs=(4, 8, 16), ks=(4, 12),
                          ells=PAPER_ELLS)
    # ks disjoint from the multigpu block above, or _dedup would fold the
    # whole-box fault family into it (same physical profiles otherwise).
    specs += gen_multigpu(gs=(4, 8), qs=(4, 8), ks=(6,),
                          ells=(8 / 3, 4.0), nvlink_mults=(None, 12.0),
                          family="correlated")
    specs += gen_random_single_multi(count=400, ps=(8, 16, 32), ks=(4, 16),
                                     rng=rng)
    specs += gen_replay(ps=(8, 16, 32), ks=(4, 16),
                        ells=(8 / 7, 2.0, 8 / 3, 4.0))
    specs += gen_detection(ps=(8, 16), ks=(12,),
                           probe_intervals=(0.01, 0.03, 0.08),
                           noises=(0.0, 0.15, 0.3),
                           fpfns=((0.0, 0.0), (0.02, 0.05), (0.08, 0.1)))
    specs += gen_topology(ps=(8, 16, 32, 64), ks=(4, 12),
                          hier_gs=(2, 4, 8), hier_qs=(4, 8, 16))
    return _dedup(specs)


GRIDS = {"smoke": smoke_grid, "full": full_grid}


def _dedup(specs: Sequence[ScenarioSpec]) -> list[ScenarioSpec]:
    seen: set[tuple] = set()
    out = []
    for s in specs:
        key = (s.p, s.n, s.k, s.slowdown, s.gpus_per_server, s.nvlink_mult,
               s.fill_bubbles, s.events, s.detection, s.algo)
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out
