"""Re-planning controller policies over an estimated failure timeline.

The detector (`repro_torch.detect.detector`) turns the true `FaultTimeline` into
an estimated one; the policies here decide which estimated changes are
worth acting on. `planner.replay` consumes the policy-filtered timeline as
its re-plan triggers while still simulating every plan against the truth:

  immediate  act on every estimated breakpoint (the oracle behavior,
             now fed by a possibly-wrong estimate);
  debounce   require the estimated state to persist K consecutive probes
             before confirming it - a one-probe FP blip or a sub-cadence
             NIC flap never confirms, at the price of (K-1) probe
             intervals of extra reaction lag on real changes;
  backoff    act immediately but enforce an exponentially growing minimum
             spacing between successive re-plans (2x after each), bounding
             re-plan churn under sustained flapping. The spacing floor is
             applied inside `planner.replay` (it depends on when re-plans
             actually land); `apply_policy` passes the timeline through.

All policies degrade gracefully to the oracle under a perfect detector:
debounce with continuous observation (probe_interval == 0) has a zero-width
confirmation window and backoff with base 0 has no floor, so the acceptance
bit-identity (perfect detector + any zero-parameter policy == the oracle) holds.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.model import BandwidthProfile, FaultEvent, FaultTimeline
from repro_torch.detect.detector import DetectionResult, true_changes

__all__ = ["MAX_CREDIBLE_ELL", "POLICIES", "ControllerConfig",
           "apply_policy", "debounce_timeline", "estimate_usable"]

POLICIES = ("immediate", "debounce", "backoff")

# An estimate claiming (almost) every NIC is degraded, or absurd severity,
# says more about the detector than the fabric: planning OptCC for it would
# pick a straggler set with no healthy helpers left. `planner.replay` then
# falls back to the degraded FIFO ring, which is valid under any profile.
MAX_CREDIBLE_ELL = 64.0


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Which policy filters the estimated timeline into re-plan triggers.

    debounce_probes: K - an estimated change must survive K consecutive
      probes (i.e. (K-1) probe intervals with no contrary estimate) before
      it confirms; K=1 degenerates to immediate.
    backoff_base: minimum spacing (element-time) between re-plan i and i+1,
      doubled after every re-plan; <= 0 auto-derives 4 probe intervals.
    """

    policy: str = "immediate"
    debounce_probes: int = 3
    backoff_base: float = 0.0

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"choose from {POLICIES}")
        if self.debounce_probes < 1:
            raise ValueError("debounce_probes must be >= 1")

    def backoff_spacing(self, probe_interval: float, replans: int) -> float:
        """Minimum time until the next re-plan after the `replans`-th one."""
        base = self.backoff_base if self.backoff_base > 0 \
            else 4.0 * probe_interval
        return base * (2.0 ** max(replans - 1, 0))


def estimate_usable(profile: BandwidthProfile) -> bool:
    """Is an estimated profile credible enough to plan OptCC for? See
    MAX_CREDIBLE_ELL; `planner.replay` forces the ring fallback otherwise."""
    stragglers = profile.stragglers
    if len(stragglers) >= profile.p - 1:
        return False
    return max(profile.slowdown) <= MAX_CREDIBLE_ELL


def debounce_timeline(timeline: FaultTimeline, profile: BandwidthProfile,
                      probe_interval: float, k: int
                      ) -> tuple[FaultTimeline, int]:
    """Confirm estimated changes that persist K consecutive probes.

    An effective change at estimated time t confirms at ``t + (k-1)*dt``
    unless a contrary estimate lands on the same rank inside that window -
    then *both* are suppressed (the state never stabilized; re-planning for
    either side of a flap is thrash). Returns (confirmed timeline,
    suppressed change count). k=1 or dt=0 is the identity.
    """
    if k <= 1 or probe_interval <= 0.0:
        return timeline, 0
    window = (k - 1) * probe_interval
    # Probe times are i*dt floats; comparing j2*dt <= (j1+k-1)*dt must not
    # hinge on float rounding of the products.
    eps = 1e-9 * probe_interval
    changes = true_changes(profile, timeline)
    events: list[FaultEvent] = []
    suppressed = 0
    for r in sorted(changes):
        chs = changes[r]
        for i, (t, v) in enumerate(chs):
            nxt = chs[i + 1][0] if i + 1 < len(chs) else None
            if nxt is not None and nxt <= t + window + eps:
                suppressed += 1
                continue
            events.append(FaultEvent(t + window, r, v))
    return FaultTimeline(tuple(events)), suppressed


def apply_policy(detection: DetectionResult, profile: BandwidthProfile,
                 config: ControllerConfig) -> tuple[FaultTimeline, int]:
    """Filter an estimate into the trigger timeline `planner.replay` walks.
    Returns (trigger timeline, suppressed estimated changes)."""
    if config.policy == "debounce":
        return debounce_timeline(detection.timeline, profile,
                                 detection.config.probe_interval,
                                 config.debounce_probes)
    return detection.timeline, 0
