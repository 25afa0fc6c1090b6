"""Closed-form lower bounds and achieved-time formulas from the paper.

A copy of `repro/core/lower_bounds.py` up to its per-topology section:
the bounds and time models the classic planner (auto/ring/optcc) reads.

All times are in *element-time units* of the bandwidth-bound model: a healthy
NIC moves one element per unit time. Multiply by (bytes_per_element /
nic_bytes_per_second) to get seconds.

Naming follows the paper:
  p  - total number of GPUs
  n  - vector length in elements
  l  - slowdown factor(s), l >= 1
  g  - GPUs per server (q = p/g servers)
  k  - number of pipeline segments
  m  - number of stragglers
"""
from __future__ import annotations

from typing import Sequence


# ----------------------------------------------------------------------------
# Fault-free optimum (Patarasuk & Yuan)
# ----------------------------------------------------------------------------

def t0_fault_free(p: int, n: float, g: int = 1) -> float:
    """T0 = 2(p-1) n / (g p): bandwidth-optimal homogeneous AllReduce."""
    return 2.0 * (p - 1) * n / (g * p)


# ----------------------------------------------------------------------------
# Lower bounds
# ----------------------------------------------------------------------------

def lb_single_straggler_tight(p: int, n: float, ell: float) -> float:
    """Theorem 6 (tight): T >= max{ 2*l*(p-1) / (l*(p-2)+2), l } * n."""
    if ell < 1.0:
        raise ValueError("ell >= 1 required")
    return max(2.0 * ell * (p - 1) / (ell * (p - 2) + 2.0), ell) * n


def lb_multi_straggler(p: int, n: float, ells: Sequence[float]) -> float:
    """Theorem 2: T >= max{ 2(p-1) / (p-m+Sum 1/l_i), l_1 } * n."""
    m = len(ells)
    if m == 0:
        return t0_fault_free(p, n)
    ell1 = max(ells)
    y0 = 2.0 * (p - 1) / (p - m + sum(1.0 / l for l in ells))
    return max(y0, ell1) * n


def lb_multi_gpu_tight(p: int, n: float, ell: float, g: int) -> float:
    """Theorem 13 (tight): T >= (n/g) * max{ 2*l*(q-1)/(l*(q-2)+2), l }."""
    q = p // g
    return (n / g) * max(2.0 * ell * (q - 1) / (ell * (q - 2) + 2.0), ell)


def lower_bound(p: int, n: float, ells: Sequence[float], g: int = 1) -> float:
    """Dispatch to the tightest applicable bound for a bandwidth profile."""
    stragglers = [l for l in ells if l > 1.0]
    if not stragglers:
        return t0_fault_free(p, n, g)
    if g > 1:
        if len(stragglers) != 1:
            raise NotImplementedError("multi-straggler multi-GPU bound not in paper")
        return lb_multi_gpu_tight(p, n, stragglers[0], g)
    if len(stragglers) == 1:
        return lb_single_straggler_tight(p, n, stragglers[0])
    return lb_multi_straggler(p, n, stragglers)


# ----------------------------------------------------------------------------
# Achieved-time closed forms for OptCC (Section 4.3, Appendices C, D.3, E.4)
#
# These are *calibrated* against the repo's flow-model simulator so that
# Plan.predicted_time is an operator-grade estimate, not just an upper-bound
# sketch: tests/test_schedule_time.py gates simulated/predicted within 10%
# at k=4 across every regime. The leading terms are the paper's; the
# pipeline-head/drain constants are fits to the simulator (the paper's
# (k+1)/k-style forms count one body of fill where the constructions here
# pay a small constant number of bodies). Constants assume the paper's
# minimum (g-1)x NVLink provisioning; with faster NVLink (e.g. DGX 12x)
# the multi-GPU form slightly over-predicts, conservatively.
# ----------------------------------------------------------------------------

def optcc_time_single(p: int, n: float, ell: float, k: int) -> float:
    """Single straggler, g=1 (Section 4.3 / Appendix C with bubble filling).

    Slotted construction (p - 1 >= 4), measured exactly:
      l >= 2:  T = (n/k) (l (k+2) + 5 - 6/(p-1))
      l <  2:  T = s_hat (2 (p-1)(k+2) + 5 (p-1) - 6),
               s_hat = l n / (((p-2) l + 2) k)   [straggler slot width]
    The l >= 2 form is bit-exact vs the simulator; the l < 2 form is within
    ~3.5% (greedy bubble filling shifts a few slots by (2 - l) s each).
    For p - 1 < 4 the generator uses the legacy alternate-orderings
    construction; those constants are separate fits.
    """
    ph = p - 1
    if ph < 4:
        if ell >= 2.0:
            return (n / k) * (ell * k + 2.5 + 0.2 * ell)
        s_hat = ell * n / (((p - 2) * ell + 2.0) * k)
        return s_hat * (7.3 * k + 4.0)
    if ell >= 2.0:
        return (n / k) * (ell * (k + 2.0) + 5.0 - 6.0 / ph)
    s_hat = ell * n / (((p - 2) * ell + 2.0) * k)
    return s_hat * (2.0 * ph * (k + 2.0) + 5.0 * ph - 6.0)


def optcc_time_multi(p: int, n: float, ells: Sequence[float], k: int) -> float:
    """m stragglers, g=1 (Appendix D.3).

    Per-segment body (s = n/(k (p-m)) is the healthy chunk width):

      T_body = max{ l1 (p-m) + 2(m-1),            # straggler upload-bound
                    2(p-1) + Sum_i (l_i - 1) } s  # healthy recv-port bound:
                                                  # every straggler's chunk
                                                  # arrives l_i-times dilated
                                                  # at some healthy recv port

    T = T_body k + T_fill s, with the pipeline head/drain fill fitted per
    regime against the simulator at k=4 (l2 = second-largest slowdown):

      straggler-bound: T_fill = 0.66(p-1) + 4.14 (m-1) l2 + 0.89 l2 (p-m)
      healthy-bound:   T_fill = 1.82 l2 (p-m) - 0.16 (m-1) l1

    Max |sim/pred - 1| over p in {8..64}, m <= 4, l in [8/7, 8]: 6.9% / 5.7%.
    """
    m = len(ells)
    ell1 = max(ells) if ells else 1.0
    srt = sorted(ells, reverse=True)
    ell2 = srt[1] if m > 1 else 1.0
    s = n / (k * (p - m))
    body_straggler = ell1 * (p - m) + 2.0 * (m - 1)
    body_healthy = 2.0 * (p - 1) + sum(l - 1.0 for l in ells)
    if body_straggler >= body_healthy:
        body = body_straggler
        fill = (0.66 * (p - 1) + 4.14 * (m - 1) * ell2
                + 0.89 * ell2 * (p - m))
    else:
        body = body_healthy
        fill = 1.82 * ell2 * (p - m) - 0.16 * (m - 1) * ell1
    return s * (body * k + fill)


def optcc_time_multi_gpu(p: int, n: float, ell: float, g: int, k: int) -> float:
    """Single straggler server, g GPUs/server (Appendix E.4 leading term).

    T = s ((q-1)(w k + fill) + tail),  s = n/(g k (q-1)),  w = max(l, 2).
    Under the paper's minimal (g-1)x NVLink provisioning and g > 2 the
    zero-slack NVLink chains congest the greedy dispatcher, costing an extra
    ~1.2 s (q-1) per segment (w += 1.2); the fills are simulator fits at k=4:

      g == 2: fill = 2.17 min(l, 2),                    tail = 1.61 l - 2.63
      g >= 4: fill = 2.252 min(l, 2) + 0.388 max(l - 2, 0) - 1.073,
              tail = 0.763 min(l, 2)

    Max |sim/pred - 1| over q in {3..32}, l in [8/7, 8]: 8.5% (g=2), 9.4%
    (g in {4, 8}) - the greedy NVLink congestion is not a smooth function
    of l, so the residual is scatter, not a missing term.
    """
    q = p // g
    s = n / (g * k * (q - 1))
    if g == 2:
        w = max(ell, 2.0)
        return s * ((q - 1) * (w * k + 2.17 * min(ell, 2.0))
                    + 1.61 * ell - 2.63)
    w = max(ell, 2.0) + 1.2
    fill = 2.252 * min(ell, 2.0) + 0.388 * max(ell - 2.0, 0.0) - 1.073
    return s * ((q - 1) * (w * k + fill) + 0.763 * min(ell, 2.0))


def optcc_time(p: int, n: float, ells: Sequence[float], k: int,
               g: int = 1) -> float:
    stragglers = [l for l in ells if l > 1.0]
    if not stragglers:
        # The FIFO ring generator builds a *flat* p-GPU ring over NICs and
        # achieves 2(p-1)n/p exactly in the flow model (tests/
        # test_schedule_time.py pins this). With g > 1 that is a factor g
        # above the hierarchical optimum t0_fault_free(p, n, g); predict
        # what the schedule does, not the unimplemented hierarchical ring.
        return t0_fault_free(p, n, 1)
    if g > 1:
        if len(stragglers) != 1:
            raise NotImplementedError
        return optcc_time_multi_gpu(p, n, stragglers[0], g, k)
    if len(stragglers) == 1:
        return optcc_time_single(p, n, stragglers[0], k)
    return optcc_time_multi(p, n, stragglers, k)
