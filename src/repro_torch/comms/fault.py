"""Fault state and failure-event plumbing for the training runtime.

A `FaultState` describes the live bandwidth profile of the DP axis. The
training loop holds one, updates it from the failure detector (here: an
injection schedule), and re-builds the train step whenever the state
changes - the analogue of NCCL communicator re-initialization, with the
OptCC planner supplying the new collective schedule in O(pk).

The port's copy of `repro/comms/fault.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.model import BandwidthProfile
from repro_torch.core.planner import Plan, make_plan


@dataclasses.dataclass(frozen=True)
class FaultState:
    """Static description of DP-axis health; hashable."""

    axis_size: int
    straggler: Optional[int] = None     # DP index of the degraded member
    ell: float = 1.0                    # slowdown factor (1.0 = healthy)

    @property
    def degraded(self) -> bool:
        return self.straggler is not None and self.ell > 1.0

    def profile(self) -> BandwidthProfile:
        if not self.degraded:
            return BandwidthProfile.healthy(self.axis_size)
        return BandwidthProfile.single_straggler(
            self.axis_size, self.ell, straggler=self.straggler)

    def plan(self, n_elements: int, k: int = 16,
             materialize: bool = False) -> Plan:
        return make_plan(self.profile(), n_elements, k,
                         materialize=materialize)


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples.

    events: {step: FaultState} - at each listed step the fault state
    changes (e.g. a NIC loss at step 100, repair at step 200).
    """

    axis_size: int
    events: dict[int, FaultState] = dataclasses.field(default_factory=dict)

    def at_step(self, step: int, current: FaultState) -> FaultState:
        return self.events.get(step, current)

    @classmethod
    def nic_loss(cls, axis_size: int, step: int, straggler: int,
                 ell: float, repair_step: Optional[int] = None
                 ) -> "FailureInjector":
        ev = {step: FaultState(axis_size, straggler, ell)}
        if repair_step is not None:
            ev[repair_step] = FaultState(axis_size)
        return cls(axis_size, ev)

    def to_timeline(self, t_per_step: float, base: Optional[FaultState] = None):
        """Bridge to the simulator's `FaultTimeline`: the step-indexed
        injection schedule as per-rank SET events at ``step * t_per_step``
        element-time.

        The injector's schedule is a sequence of whole-cluster states; the
        timeline wants per-rank deltas, so consecutive states are diffed and
        only ranks whose slowdown actually changes emit events (a repair
        emits the explicit return to 1.0). `base` is the state before the
        first event (default: healthy). The result plugs straight into
        `planner.replay` / `detect.estimate_timeline`, letting one injection
        schedule drive both the runtime path and the what-if simulation.
        """
        from repro_torch.core.model import FaultTimeline
        if t_per_step <= 0:
            raise ValueError("t_per_step must be > 0")
        cur = (base if base is not None
               else FaultState(self.axis_size)).profile().slowdown
        triples: list[tuple[float, int, float]] = []
        for step in sorted(self.events):
            nxt = self.events[step].profile().slowdown
            for r, (a, b) in enumerate(zip(cur, nxt)):
                if a != b:
                    triples.append((step * t_per_step, r, b))
            cur = nxt
        return FaultTimeline.make(triples)


class FaultAwareSync:
    """Gradient-sync selector: psum when healthy, optcc when degraded."""

    def __init__(self, state: FaultState):
        self.state = state

    def grad_sync_kind(self) -> str:
        return "optcc" if self.state.degraded else "psum"
