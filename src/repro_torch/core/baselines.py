"""Baselines from the paper's evaluation (Section 5).

  * nccl_no_failure : ring AllReduce on the healthy topology (T -> T0).
  * iccl            : ring AllReduce resumed unchanged on the degraded
                      topology [1] - simulate ring on the degraded profile.
  * r2ccl           : state-of-the-art NIC-fault-tolerant AllReduce [30];
                      the paper gives its closed form (Fig. 20 caption):
                      T = T_NCCL_optimal * (1 + p (l-1) / (2 (p-1))).
"""
from __future__ import annotations

from repro_torch.core.lower_bounds import t0_fault_free
from repro_torch.core.model import BandwidthProfile
from repro_torch.core.ring import ring_allreduce_schedule
from repro_torch.core.simulator import simulate


def nccl_no_failure_time(p: int, n: float, g: int = 1) -> float:
    return t0_fault_free(p, n, g)


def iccl_time_asymptotic(p: int, n: float, ell: float, g: int = 1) -> float:
    """Degraded ring: the straggler's port carries the full per-rank volume
    at rate 1/l, throttling every round: T -> l * T0."""
    return ell * t0_fault_free(p, n, g)


def iccl_time_simulated(profile: BandwidthProfile, n: int) -> float:
    return simulate(ring_allreduce_schedule(profile, n)).makespan


def r2ccl_time(p: int, n: float, ell: float, g: int = 1) -> float:
    """Closed form reported by the paper for R2CCL."""
    return t0_fault_free(p, n, g) * (1.0 + p * (ell - 1.0) / (2.0 * (p - 1)))
