"""Online re-planning: bandwidth profile -> collective plan.

The port's copy of the classic planner of `repro/core/planner.py`
(`make_plan` with ``algo`` in auto/ring/optcc, ``materialize=False``): it
picks OptCC or the FIFO ring for a bandwidth profile in closed form and
carries the theory beside the choice - the profile's lower bound, the
predicted completion time and the fault-free optimum - so the runtime can
report the expected overhead when it re-plans. The O(p k) slot descriptor,
the materialized schedules, the other registry topologies and `replay`
stay in the JAX package until the slice that ports the simulator.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core import lower_bounds as lb
from repro_torch.core.model import BandwidthProfile


def topology_of(algo: str) -> str:
    """Normalize a plan `algo` to its registry topology name: the optcc
    dispatcher's per-regime variants ("optcc-single", "optcc-multi",
    "optcc-multigpu") all collapse to "optcc"; everything else is its own
    topology."""
    if algo.startswith("optcc"):
        return "optcc"
    return algo


@dataclasses.dataclass
class Plan:
    profile: BandwidthProfile
    algo: str                    # "ring" or "optcc-*"
    lower_bound: float           # element-time units
    predicted_time: float        # closed-form achieved time
    t0: float                    # fault-free optimum
    gen_seconds: float           # wall time to construct the plan
    topology: str = ""           # registry name (topology_of(algo))

    def __post_init__(self):
        if not self.topology:
            self.topology = topology_of(self.algo)

    @property
    def predicted_overhead(self) -> float:
        """Predicted slowdown vs the fault-free optimum (1.0 = none)."""
        return self.predicted_time / self.t0 if self.t0 else float("inf")


def make_plan(profile: BandwidthProfile, n: int, k: int = 16,
              algo: str = "auto") -> Plan:
    """The OptCC-vs-ring planner.

    * ``"auto"`` picks the predicted-faster of OptCC and the FIFO ring; the
      ring on a degraded profile costs exactly l_max 2(p-1)n/p, and ties go
      to the ring (so a healthy profile plans the ring).
    * ``"ring"`` plans the FIFO ring unconditionally.
    * ``"optcc"`` plans the paper's schedule family unconditionally.
    """
    if algo not in ("auto", "ring", "optcc"):
        raise ValueError(f"algo {algo!r} is not ported; the port plans "
                         "auto, ring or optcc")
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
    else:
        optcc_pred = lb.optcc_time(profile.p, n, ells, k, g)
        use_ring = (algo == "auto"
                    and ring_pred <= optcc_pred)  # healthy ties -> ring
    gen_s = time.perf_counter() - t_start
    if use_ring:
        plan_algo = "ring"
    elif g > 1:
        plan_algo = "optcc-multigpu"
    else:
        plan_algo = "optcc-single" if len(ells) == 1 else "optcc-multi"
    return Plan(
        profile=profile,
        algo=plan_algo,
        lower_bound=lb.lower_bound(profile.p, n, ells, g),
        predicted_time=ring_pred if use_ring else optcc_pred,
        t0=lb.t0_fault_free(profile.p, n, g),
        gen_seconds=gen_s,
    )
