"""Critical-path walk and per-stage attribution of a simulated makespan.

The walk starts at the last-finishing flow and steps backward through
whatever made each flow start when it did: its latest-finishing dependency,
or the latest flow that occupied one of its ports up to its start time
(ports are exclusive, so that flow is the binding resource conflict). When
even the best predecessor finished strictly before the flow started, the
remaining wait is a *stall* (slot release in the slotted schedules) and is
booked against the waiting flow's stage as ``stall:<stage>``.

The resulting segments and gaps tile [0, makespan] with no overlap, so the
per-stage sums telescope to the simulated total exactly (floating-point
summation error only - a few ulps, far inside the 1e-9 relative tolerance
the tests and artifact validator pin).
"""
from __future__ import annotations

import bisect
import math

import numpy as np

from repro_torch.obs.telemetry import FlowTelemetry


def _port_index(tele: FlowTelemetry) -> dict[int, tuple[list, list]]:
    """port id -> (finish times sorted ascending, fids in that order),
    wire flows only. Lets the walk binary-search 'latest flow on this port
    finishing at or before t'."""
    w = np.nonzero(tele.wire)[0]
    idx: dict[int, tuple[list, list]] = {}
    if not len(w):
        return idx
    nvw = tele.nv[w].astype(np.int64)
    for pid_arr in (tele.src[w] * 4 + nvw * 2,
                    tele.dst[w] * 4 + nvw * 2 + 1):
        for pid in np.unique(pid_arr):
            sel = w[pid_arr == pid]
            o = np.argsort(tele.finish[sel], kind="stable")
            sel = sel[o]
            idx[int(pid)] = (tele.finish[sel].tolist(), sel.tolist())
    return idx


def critical_path(tele: FlowTelemetry) -> tuple[list[dict], list[dict]]:
    """Walk the chain that determined the makespan.

    Returns (segments, gaps), both in increasing-time order:
      segments: {"fid", "stage", "start", "finish"} - flows on the path;
      gaps:     {"fid", "stage", "t0", "t1"} - idle waits immediately
                before segment `fid` started (release stalls, or the lead-in
                before the first flow).
    Together they tile [0, makespan] without overlap.
    """
    n = tele.nflows
    if n == 0 or tele.makespan <= 0:
        return [], []
    pindex = _port_index(tele)
    start, finish = tele.start, tele.finish
    cur = int(np.argmax(finish))
    segments: list[dict] = []
    gaps: list[dict] = []
    while True:
        segments.append({"fid": cur, "stage": tele.stage_of(cur),
                         "start": float(start[cur]),
                         "finish": float(finish[cur])})
        best, best_t = -1, -math.inf
        for d in tele.deps_of(cur).tolist():
            t = float(finish[d])
            if t > best_t or (t == best_t and d < best):
                best, best_t = d, t
        if tele.size[cur] > 0:
            # Latest flow to occupy either of cur's ports before it started.
            for pid in (tele.sport(cur), tele.rport(cur)):
                fin_s, fid_s = pindex[pid]
                j = bisect.bisect_right(fin_s, float(start[cur])) - 1
                if j >= 0:
                    d, t = fid_s[j], fin_s[j]
                    if d != cur and (t > best_t
                                     or (t == best_t and d < best)):
                        best, best_t = d, t
        if best < 0:
            if start[cur] > 0.0:
                gaps.append({"fid": cur, "stage": tele.stage_of(cur),
                             "t0": 0.0, "t1": float(start[cur])})
            break
        if best_t < start[cur]:
            gaps.append({"fid": cur, "stage": tele.stage_of(cur),
                         "t0": best_t, "t1": float(start[cur])})
        cur = best
    segments.reverse()
    gaps.reverse()
    return segments, gaps


def stage_breakdown(tele: FlowTelemetry) -> dict[str, float]:
    """Makespan attributed to stages along the critical path.

    Keys are stage names (plus ``stall:<stage>`` for waits); values are
    absolute element-time contributions summing to the makespan. Zero-sum
    buckets (self-store hops) are dropped.
    """
    segments, gaps = critical_path(tele)
    parts: dict[str, list[float]] = {}
    for s in segments:
        parts.setdefault(s["stage"], []).append(s["finish"] - s["start"])
    for g in gaps:
        parts.setdefault("stall:" + g["stage"], []).append(g["t1"] - g["t0"])
    out = {k: math.fsum(v) for k, v in parts.items()}
    return {k: v for k, v in out.items() if v != 0.0}
