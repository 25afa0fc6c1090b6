"""Probe-based fault-detection model: the imperfect lens between the true
failure timeline and the re-planning controller.

`planner.replay`'s default controller is an oracle: it reacts to every rate
change with zero delay and perfect knowledge of the new bandwidth vector.
Real collective libraries see degradation through periodic health probes
(NIC counters, RDMA CM events, in-band RTT probes) that lag, quantize and
occasionally lie - R2CCL builds its recovery path around explicit bounded-
latency detection, and the observable-CCL work shows detection/attribution
latency dominating real recovery times (PAPERS.md). This module models that
lens: it observes a ground-truth `FaultTimeline` and emits an *estimated*
timeline that lags and distorts it.

The detector samples per-rank NIC state at probe ticks ``i * probe_interval``
(i >= 1); a probe at time ``t`` sees the state as of ``t - latency``
(sensing/aggregation delay). When the sampled state differs from the last
value the detector reported for that rank, it reports the change - unless a
per-probe false-negative coin says the probe missed it, in which case the
next probe retries (geometric extra lag). Reported slowdowns are distorted
multiplicatively on the degradation magnitude (``1 + (ell-1) * e^{N(0,
noise)}`` - a recovery to 1.0 is always reported as exactly 1.0) and then
quantized to a grid of ``quant`` (telemetry counters have finite
resolution). Independently, each probe tick may fire a false positive: a
spurious degradation on a currently-healthy rank that clears at the next
probe (the one-probe blip the debounce policy exists to suppress).

``probe_interval == 0`` means continuous observation: changes are reported
``latency`` after they happen (exactly on time for ``latency == 0``), and
the per-probe FP/FN machinery is unavailable. `DetectorConfig.perfect()` is
the fully transparent lens: the estimated timeline reproduces the truth
event-for-event with identical floats, which is what keeps oracle-mode
`planner.replay` bit-identical (tests/test_torch_replay.py holds it).

All times are element-time units (the simulator clock). Randomness comes
from stream-split `random.Random` instances seeded from ``config.seed``, so
an estimate is a pure function of (profile, timeline, horizon, config).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.core.model import BandwidthProfile, FaultEvent, FaultTimeline

__all__ = ["DetectorConfig", "DetectionResult", "estimate_timeline",
           "true_changes"]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """How imperfectly the runtime sees the fabric.

    probe_interval: element-time between health probes; 0 = continuous
      observation (no probes, no FP/FN).
    latency: fixed sensing delay - a probe at t sees the state of
      t - latency; with probe_interval == 0, changes surface latency late.
    noise: sigma of the multiplicative lognormal distortion applied to the
      degradation magnitude (ell - 1) of reported slowdowns.
    quant: reported ell values are snapped to 1 + m * quant (m integer,
      nearest); 0 disables quantization.
    fp_rate: per-probe probability of a spurious one-probe degradation blip
      on a random currently-healthy rank.
    fn_rate: per-probe probability that a probe misses a pending change
      (the next probe retries).
    fp_ell: severity reported by false-positive blips.
    seed: RNG seed; estimates are deterministic given (inputs, seed).
    """

    probe_interval: float = 0.0
    latency: float = 0.0
    noise: float = 0.0
    quant: float = 0.0
    fp_rate: float = 0.0
    fn_rate: float = 0.0
    fp_ell: float = 2.0
    seed: int = 0

    def __post_init__(self):
        if self.probe_interval < 0 or self.latency < 0:
            raise ValueError("probe_interval and latency must be >= 0")
        if self.noise < 0 or self.quant < 0:
            raise ValueError("noise and quant must be >= 0")
        if not (0.0 <= self.fp_rate < 1.0 and 0.0 <= self.fn_rate < 1.0):
            raise ValueError("fp_rate and fn_rate must be in [0, 1)")
        if self.fp_ell < 1.0:
            raise ValueError("fp_ell must be >= 1")
        if self.probe_interval == 0.0 and (self.fp_rate or self.fn_rate):
            raise ValueError("false positives/negatives need discrete "
                             "probes (probe_interval > 0)")

    @property
    def is_perfect(self) -> bool:
        """A fully transparent lens: the estimate equals the truth."""
        return (self.probe_interval == 0.0 and self.latency == 0.0
                and self.noise == 0.0 and self.quant == 0.0
                and self.fp_rate == 0.0 and self.fn_rate == 0.0)

    @classmethod
    def perfect(cls) -> "DetectorConfig":
        return cls()

    @classmethod
    def default(cls, scale: float = 1.0, seed: int = 0) -> "DetectorConfig":
        """The default *imperfect* detector: probes every 0.04 time-scales
        (pass the scenario's fault-free optimum T0 as `scale` so the lens
        degrades proportionally at every cluster size), 0.01-scale sensing
        latency, 15% multiplicative noise, quarter-step ell quantization,
        2% FP and 5% FN per probe."""
        return cls(probe_interval=0.04 * scale, latency=0.01 * scale,
                   noise=0.15, quant=0.25, fp_rate=0.02, fn_rate=0.05,
                   seed=seed)


@dataclasses.dataclass(frozen=True)
class DetectionResult:
    """An estimated timeline plus how the lens performed against the truth.

    lags: detection lag (report time - true change time) per reported true
      change, in element-time. missed: true changes never reported within
      the horizon (superseded between probes, or quantized/FN'd away).
    false_events: spurious FP events injected (blip + clear pairs count 1).
    """

    timeline: FaultTimeline
    config: DetectorConfig
    probes: int
    lags: tuple[float, ...]
    missed: int
    false_events: int

    @property
    def lag_mean(self) -> Optional[float]:
        return sum(self.lags) / len(self.lags) if self.lags else None

    @property
    def lag_max(self) -> Optional[float]:
        return max(self.lags) if self.lags else None


def true_changes(profile: BandwidthProfile, timeline: FaultTimeline
                 ) -> dict[int, list[tuple[float, float]]]:
    """Per-rank effective value changes after t=0: {rank: [(t, new_ell),
    ...]}. Thin alias over `FaultTimeline.changes` kept as the detect-layer
    entry point (the detector samples this view through its probe lens)."""
    return timeline.changes(profile)


def _distort(ell: float, config: DetectorConfig,
             rng: random.Random) -> float:
    """Noise + quantization of a reported slowdown. Recoveries pass through
    exactly (a link that is back is unambiguous; what is noisy is *how
    degraded* a degraded link is)."""
    if ell <= 1.0:
        return 1.0
    est = ell
    if config.noise > 0.0:
        est = 1.0 + (ell - 1.0) * rng.lognormvariate(0.0, config.noise)
    if config.quant > 0.0:
        est = 1.0 + round((est - 1.0) / config.quant) * config.quant
    return max(1.0, est)


def _value_at(changes: list[tuple[float, float]], base: float,
              t: float) -> float:
    """True value of a rank at time t given its change list (t<0 -> base)."""
    v = base
    for ct, cv in changes:
        if ct > t:
            break
        v = cv
    return v


def estimate_timeline(profile: BandwidthProfile, timeline: FaultTimeline,
                      horizon: float, config: DetectorConfig
                      ) -> DetectionResult:
    """Observe `timeline` (resolved against `profile`) through the lens of
    `config` up to `horizon`: returns the estimated timeline the controller
    will re-plan from, plus lag/miss/FP statistics.

    The launch profile itself (t=0 state) is assumed known exactly - the
    runtime measured it when it planned - so estimation concerns mid-flight
    changes only, mirroring `planner.replay`'s t<=0 folding.
    """
    if horizon < 0:
        raise ValueError("horizon must be >= 0")
    changes = true_changes(profile, timeline)
    if config.is_perfect:
        events = tuple(FaultEvent(t, r, v)
                       for r in sorted(changes)
                       for t, v in changes[r])
        return DetectionResult(timeline=FaultTimeline(events), config=config,
                               probes=0,
                               lags=(0.0,) * len(events), missed=0,
                               false_events=0)

    rng_noise = random.Random(f"{config.seed}:noise")
    rng_fn = random.Random(f"{config.seed}:fn")
    rng_fp = random.Random(f"{config.seed}:fp")
    events: list[FaultEvent] = []
    lags: list[float] = []
    reported_total = 0
    total_changes = sum(len(c) for c in changes.values())

    if config.probe_interval == 0.0:
        # Continuous observation: every change surfaces `latency` late with
        # a distorted value; nothing can be missed or invented.
        for r in sorted(changes):
            for t, v in changes[r]:
                if t + config.latency > horizon:
                    continue
                events.append(FaultEvent(t + config.latency, r,
                                         _distort(v, config, rng_noise)))
                lags.append(config.latency)
                reported_total += 1
        return DetectionResult(timeline=FaultTimeline(tuple(events)),
                               config=config, probes=0, lags=tuple(lags),
                               missed=total_changes - reported_total,
                               false_events=0)

    dt = config.probe_interval
    nprobes = int(horizon / dt)
    probe_times = [i * dt for i in range(1, nprobes + 1)]
    # Per-rank state sampling: a probe reports iff the (lagged) true value
    # differs from the last value this detector reported for the rank.
    # Changes that flap faster than the probe cadence are superseded
    # unseen - exactly the blindness a debounce policy trades lag for.
    for r in sorted(changes):
        base_v = profile.slowdown[r]
        last_seen = base_v
        for pt in probe_times:
            v = _value_at(changes[r], base_v, pt - config.latency)
            if v == last_seen:
                continue
            if config.fn_rate and rng_fn.random() < config.fn_rate:
                continue                      # missed; next probe retries
            events.append(FaultEvent(pt, r, _distort(v, config, rng_noise)))
            # Lag is measured against the change that set the sampled value.
            ct = max(t for t, cv in changes[r] if t <= pt - config.latency)
            lags.append(pt - ct)
            reported_total += 1
            last_seen = v
    # False positives: one-probe blips on currently-healthy ranks.
    false_events = 0
    for pt in probe_times:
        if not config.fp_rate or rng_fp.random() >= config.fp_rate:
            continue
        healthy = [r for r in range(profile.p)
                   if _value_at(changes.get(r, []), profile.slowdown[r],
                                pt) <= 1.0]
        if not healthy:
            continue
        r = healthy[rng_fp.randrange(len(healthy))]
        events.append(FaultEvent(pt, r, config.fp_ell))
        events.append(FaultEvent(pt + dt, r, 1.0))
        false_events += 1
    return DetectionResult(timeline=FaultTimeline(tuple(events)),
                           config=config, probes=nprobes, lags=tuple(lags),
                           missed=total_changes - reported_total,
                           false_events=false_events)
