"""Imperfect fault detection + controller policies.

The layer between ground truth (`core.model.FaultTimeline`) and reaction
(`core.planner.replay`): a probe-based detector that observes the true
timeline through a configurable lens (latency, probe cadence, noise,
quantization, FP/FN rates) and controller policies (immediate / debounce /
backoff) that decide which estimated changes trigger a re-plan. Plans are
generated from the *estimate* but always simulated against the *truth* -
mis-plan-tolerant execution - so the sweep's `detection` family can score
real controller policies against the zero-delay oracle
(`overhead_vs_oracle`).

Public API:
  DetectorConfig, DetectionResult, estimate_timeline   - the lens
  ControllerConfig, POLICIES, apply_policy,
  debounce_timeline, estimate_usable                   - the policies
"""
from repro_torch.detect.controller import (MAX_CREDIBLE_ELL, POLICIES,
                                     ControllerConfig, apply_policy,
                                     debounce_timeline, estimate_usable)
from repro_torch.detect.detector import (DetectionResult, DetectorConfig,
                                   estimate_timeline, true_changes)

__all__ = [
    "DetectorConfig", "DetectionResult", "estimate_timeline", "true_changes",
    "ControllerConfig", "POLICIES", "MAX_CREDIBLE_ELL", "apply_policy",
    "debounce_timeline", "estimate_usable",
]
