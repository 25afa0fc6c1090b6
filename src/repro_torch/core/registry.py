"""Named registry of AllReduce schedule generators.

Every algorithm the planner can emit is a `ScheduleAlgo` entry here:

    name         registry key, also the value of `Schedule.meta["topology"]`
                 and the `algo=` argument to `planner.make_plan`
    generate     (profile, n, k, fill_bubbles) -> Schedule (Flow objects)
    generate_arrays
                 optional vectorized twin returning a columnar
                 `FlowArrays` schedule (None -> fall back to `generate`)
    time_model   (profile, n, k) -> predicted makespan, element-time units
    lower_bound  (profile, n) -> this topology's own lower bound
                 (`core.lower_bounds`); sweeps score overhead against it
    supports     profile predicate (e.g. torus2d needs a 2-D factorization,
                 hierarchical needs gpus_per_server >= 2)
    auto         whether `make_plan(algo="auto")` may pick it. Only the
                 classic pair (ring, optcc) is auto-eligible: their time
                 models are simulator-calibrated, so "auto" reproduces the
                 historical OptCC-vs-ring choice bit-for-bit. New entries
                 join "auto" once their models are calibrated the same way.
    wins_when    one-line guidance surfaced in docs/benchmarks

Use `get(name)` / `names()` / `supported(profile)`; `register` is public so
out-of-tree experiments can add entries without patching the planner.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import lower_bounds as lb
from repro_torch.core.model import BandwidthProfile, Schedule


@dataclasses.dataclass(frozen=True)
class ScheduleAlgo:
    """One registered AllReduce algorithm (see module docstring)."""

    name: str
    description: str
    generate: Callable[..., Schedule]
    time_model: Callable[[BandwidthProfile, float, int], float]
    lower_bound: Callable[[BandwidthProfile, float], float]
    generate_arrays: Optional[Callable[..., Schedule]] = None
    supports: Callable[[BandwidthProfile], bool] = lambda profile: True
    auto: bool = False
    wins_when: str = ""


_REGISTRY: dict[str, ScheduleAlgo] = {}


def register(algo: ScheduleAlgo) -> ScheduleAlgo:
    if algo.name in _REGISTRY:
        raise ValueError(f"schedule algo {algo.name!r} already registered")
    _REGISTRY[algo.name] = algo
    return algo


def get(name: str) -> ScheduleAlgo:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown schedule algo {name!r}; registered: "
                         f"{', '.join(sorted(_REGISTRY))} (or 'auto')"
                         ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def supported(profile: BandwidthProfile) -> tuple[str, ...]:
    return tuple(name for name in names()
                 if _REGISTRY[name].supports(profile))


def auto_candidates() -> tuple[ScheduleAlgo, ...]:
    return tuple(_REGISTRY[name] for name in names() if _REGISTRY[name].auto)


# ----------------------------------------------------------------------------
# built-in entries
# ----------------------------------------------------------------------------

def _dedup_ells(profile: BandwidthProfile) -> list[float]:
    """The planner's historical straggler normalization: with g > 1 the
    paper's construction handles exactly one degraded server, so collapse
    to the worst slowdown."""
    ells = [l for l in profile.slowdown if l > 1.0]
    if profile.gpus_per_server > 1 and ells:
        ells = [max(ells)]
    return ells


def _generic_lb(profile: BandwidthProfile, n: float) -> float:
    return lb.lower_bound(profile.p, n, _dedup_ells(profile),
                          profile.gpus_per_server)


def _ring_generate(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.ring import ring_allreduce_schedule
    return ring_allreduce_schedule(profile, n)


def _ring_generate_arrays(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.schedule_vec import ring_arrays
    return ring_arrays(profile, n)


def _ring_time(profile, n, k=16):
    return max(profile.slowdown) * lb.t0_fault_free(profile.p, n, 1)


def _optcc_generate(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.schedule import optcc_schedule
    return optcc_schedule(profile, n, k, fill_bubbles)


def _optcc_generate_arrays(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.schedule_vec import optcc_schedule_arrays
    return optcc_schedule_arrays(profile, n, k, fill_bubbles)


def _optcc_time(profile, n, k=16):
    return lb.optcc_time(profile.p, n, _dedup_ells(profile), k,
                         profile.gpus_per_server)


def _hier_generate(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.topologies import hierarchical_schedule
    return hierarchical_schedule(profile, n, k, fill_bubbles)


def _dbtree_generate(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.topologies import dbtree_schedule
    return dbtree_schedule(profile, n, k)


def _torus2d_generate(profile, n, k=16, fill_bubbles=True):
    from repro_torch.core.topologies import torus2d_schedule
    return torus2d_schedule(profile, n)


def _torus2d_supports(profile: BandwidthProfile) -> bool:
    from repro_torch.core.topologies import torus_dims
    return profile.gpus_per_server == 1 and torus_dims(profile.p) is not None


register(ScheduleAlgo(
    name="ring",
    description="FIFO bidirectional-chunk ring (Patarasuk & Yuan); the "
                "whole ring runs at the slowest NIC's rate",
    generate=_ring_generate,
    generate_arrays=_ring_generate_arrays,
    time_model=_ring_time,
    lower_bound=_generic_lb,
    supports=lambda profile: profile.p >= 2,
    auto=True,
    wins_when="healthy clusters, or stragglers so mild that OptCC's "
              "asymmetry costs more than it saves",
))

register(ScheduleAlgo(
    name="optcc",
    description="the paper's straggler-aware schedule family "
                "(single/multi-straggler and multi-GPU constructions, "
                "dispatched per profile)",
    generate=_optcc_generate,
    generate_arrays=_optcc_generate_arrays,
    time_model=_optcc_time,
    lower_bound=_generic_lb,
    supports=lambda profile: profile.p >= 2,
    auto=True,
    wins_when="one or a few degraded NICs on an otherwise healthy "
              "cluster - approaches the per-profile lower bound",
))

register(ScheduleAlgo(
    name="hierarchical",
    description="intra-server NVLink reduce + inter-server OptCC over one "
                "lead rank per server",
    generate=_hier_generate,
    time_model=lb.hierarchical_time,
    lower_bound=lb.lb_hierarchical,
    supports=lambda profile: profile.gpus_per_server >= 2,
    wins_when="multi-GPU servers with fast NVLink (nvlink_mult >> g-1): "
              "only q ranks ever touch the scarce NICs",
))

register(ScheduleAlgo(
    name="dbtree",
    description="double-binary-tree baseline (two balanced trees, each "
                "reducing+broadcasting half the vector)",
    generate=_dbtree_generate,
    time_model=lb.dbtree_time,
    lower_bound=lb.lb_dbtree,
    supports=lambda profile: profile.gpus_per_server == 1 and profile.p >= 2,
    wins_when="latency-bound regimes (tiny n, large p) - bandwidth-wise "
              "it moves ~2n per interior rank and loses to ring/optcc",
))

register(ScheduleAlgo(
    name="torus2d",
    description="2-D torus reduce (row RS, column RS, column AG, row AG) "
                "per the Google mesh paper",
    generate=_torus2d_generate,
    time_model=lb.torus2d_time,
    lower_bound=lb.lb_torus2d,
    supports=_torus2d_supports,
    wins_when="mesh/torus fabrics; bandwidth-optimal like the ring but "
              "with r- and c-length dependency chains instead of p",
))
