"""Closed-form lower bounds and achieved-time formulas from the paper.

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

def lb_single_straggler(p: int, n: float, ell: float) -> float:
    """Theorem 1: T >= max{ 2*l*(p-1) / (l*(p-1)+1), l } * n."""
    if ell < 1.0:
        raise ValueError("ell >= 1 required")
    return max(2.0 * ell * (p - 1) / (ell * (p - 1) + 1.0), ell) * n


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


def lb_multi_gpu(p: int, n: float, ell: float, g: int) -> float:
    """Theorem 3: T >= (n/g) * max{ 2*l*(q-1)/(1+l*(q-1)), l }, q = p/g."""
    q = p // g
    return (n / g) * max(2.0 * ell * (q - 1) / (1.0 + ell * (q - 1)), ell)


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


def timeline_lower_bound(profile, timeline, n: float) -> float:
    """Lower bound for a run under a `FaultTimeline` (core.model).

    Uses the static bound of the per-rank *best-ever* profile
    (`timeline.min_profile`): the flow model is monotone in the slowdown
    vector (every flow is pointwise no slower when every rank is at its
    fastest-ever rate), so the static bound of that profile bounds any
    schedule under the timeline. Deliberately not an integral/averaged
    bound - those are not sound when the adversary controls *when* work is
    scheduled relative to the fault windows.
    """
    best = timeline.min_profile(profile)
    ells = [l for l in best.slowdown if l > 1.0]
    return lower_bound(best.p, n, ells, best.gpus_per_server)


# ----------------------------------------------------------------------------
# Achieved-time closed forms for OptCC (Section 4.3, Appendices C, D.3, E.4)
#
# These are *calibrated* against the repo's flow-model simulator so that
# Plan.predicted_time is an operator-grade estimate, not just an upper-bound
# sketch: the JAX package's schedule-time tests gate simulated/predicted within 10%
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
        # achieves 2(p-1)n/p exactly in the flow model (the JAX package's
        # schedule-time tests pin this). With g > 1 that is a factor g
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


# ----------------------------------------------------------------------------
# Per-topology bounds and time models (schedule registry)
#
# Unlike the ell-parameterized paper bounds above, these take the full
# BandwidthProfile: the tree/torus bounds depend on *which* rank is slow
# (an interior tree rank hurts; a leaf barely does), not just the multiset
# of slowdowns. Each bound is the port-occupancy argument - a rank's NIC
# send (resp. recv) port must serialize all bytes it sends (receives),
# each at >= size * slowdown - evaluated on the exact integer splits the
# matching generator in `core.topologies` emits, so rounding can never
# push the bound above the simulated time. The time models are reporting
# estimates (registry `auto=False` entries never steer `make_plan`).
# ----------------------------------------------------------------------------

def lb_dbtree(profile, n: float) -> float:
    """Double binary tree: rank r's NIC moves `dbtree_traffic[r]` in each
    direction (send == recv), so T >= max_r traffic[r] * l_r."""
    import numpy as np

    from repro_torch.core.topologies import dbtree_traffic
    traffic = dbtree_traffic(profile.p, n)
    return float(np.max(traffic * np.asarray(profile.slowdown)))


def dbtree_time(profile, n: float, k: int) -> float:
    """Traffic bound plus the up-and-down pipeline ramp: ~2 * depth hops of
    one n/(2k) segment each at the slowest rate."""
    import math
    depth = math.ceil(math.log2(profile.p + 1))
    return (lb_dbtree(profile, n)
            + 2.0 * depth * (n / (2.0 * max(k, 1))) * max(profile.slowdown))


def lb_torus2d(profile, n: float) -> float:
    """2-D torus: T >= max_r max(send_r, recv_r) * l_r over the exact
    4-phase traffic of the generator's splits."""
    import numpy as np

    from repro_torch.core.topologies import torus2d_traffic
    send, recv = torus2d_traffic(profile.p, n)
    sl = np.asarray(profile.slowdown)
    return float(np.max(np.maximum(send, recv) * sl))


def torus2d_time(profile, n: float, k: int = 0) -> float:
    """Sum over the 4 phases of that phase's slowest port (the phases are
    barrier-separated per chunk, so this always dominates `lb_torus2d`)."""
    import numpy as np

    from repro_torch.core.topologies import torus2d_traffic
    sl = np.asarray(profile.slowdown)
    total = 0.0
    for send, recv in torus2d_traffic(profile.p, n, per_phase=True):
        total += float(np.max(np.maximum(send, recv) * sl))
    return total


def _hier_lead_ells(profile) -> list:
    g = profile.gpus_per_server
    leads = [profile.slowdown[s * g] for s in range(profile.num_servers)]
    return [l for l in leads if l > 1.0]


def lb_hierarchical(profile, n: float) -> float:
    """Hierarchical (NVLink reduce per server + inter-server collective over
    one lead per server): the leads' NICs execute a q-rank AllReduce of the
    server sums (universal q-rank bound at the leads' *actual* NIC rates),
    and every non-lead GPU must push its full vector out - and pull the
    full result back in - over NVLink."""
    q = profile.num_servers
    return max(lower_bound(q, n, _hier_lead_ells(profile), 1),
               n / profile.nvlink_rate)


def hierarchical_time(profile, n: float, k: int) -> float:
    """Inner OptCC/ring prediction on the server-level profile plus the
    NVLink collect + distribute chains (imperfectly overlapped)."""
    from repro_torch.core.topologies import server_slowdowns
    q = profile.num_servers
    inner_ells = [l for l in server_slowdowns(profile) if l > 1.0]
    if inner_ells:
        inner = optcc_time(q, n, inner_ells, k, 1)
    else:
        inner = t0_fault_free(q, n, 1)
    return inner + 2.0 * n / profile.nvlink_rate


# ----------------------------------------------------------------------------
# Asymptotic (k -> inf) versions, for benchmark plots
# ----------------------------------------------------------------------------

def optcc_time_asymptotic(p: int, n: float, ells: Sequence[float],
                          g: int = 1) -> float:
    stragglers = [l for l in ells if l > 1.0]
    if not stragglers:
        return t0_fault_free(p, n, g)
    if g > 1:
        (ell,) = stragglers
        return (n / g) * max(ell, 2.0)
    if len(stragglers) == 1:
        (ell,) = stragglers
        if ell >= 2.0:
            return ell * n
        return 2.0 * (p - 1) * ell * n / ((p - 2) * ell + 2.0)
    m = len(stragglers)
    ell1 = max(stragglers)
    return max(2.0 * (p - 1) / (p - m), ell1 + 2.0 * (m - 1) / (p - m)) * n
