"""Chrome-trace (Perfetto / chrome://tracing JSON) export of a simulation.

Layout: one trace *process* per rank; within it one *thread* lane per port
(nic-send, nic-recv, and for multi-GPU schedules nv-send/nv-recv). Every
wire flow becomes one complete ("X") event on its sender's send lane and
one on its receiver's recv lane - ports are exclusive, so events never
overlap within a lane. A final process holds the critical-path lane:
the flows on the path plus ``stall:*`` slices for attributed waits.

Element-time maps 1:1 to trace microseconds (the viewer's native unit);
absolute numbers are model time units, not wall clock.
"""
from __future__ import annotations

import json

from repro_torch.obs.critical_path import critical_path
from repro_torch.obs.telemetry import FlowTelemetry

# tid per (nv, direction): deliberately mirrors the simulator's port id
# low bits so a lane is identifiable from the raw trace.
_LANES = {(False, "s"): 0, (False, "r"): 1, (True, "s"): 2, (True, "r"): 3}
_LANE_NAMES = {0: "nic-send", 1: "nic-recv", 2: "nv-send", 3: "nv-recv"}


def chrome_trace(tele: FlowTelemetry, name: str = "allreduce") -> dict:
    """Build the trace as a JSON-serializable dict."""
    events: list[dict] = []
    cp_pid = tele.p
    for r in range(tele.p):
        events.append({"ph": "M", "name": "process_name", "pid": r, "tid": 0,
                       "args": {"name": f"rank {r}"}})
        lanes = (0, 1, 2, 3) if tele.gpus_per_server > 1 else (0, 1)
        for tid in lanes:
            events.append({"ph": "M", "name": "thread_name", "pid": r,
                           "tid": tid, "args": {"name": _LANE_NAMES[tid]}})
    events.append({"ph": "M", "name": "process_name", "pid": cp_pid,
                   "tid": 0, "args": {"name": "critical path"}})

    for fid in range(tele.nflows):
        if tele.size[fid] <= 0:
            continue
        ts = float(tele.start[fid])
        dur = float(tele.finish[fid]) - ts
        stage = tele.stage_of(fid)
        nv = bool(tele.nv[fid])
        args = {"fid": fid, "src": int(tele.src[fid]),
                "dst": int(tele.dst[fid]), "size": float(tele.size[fid]),
                "stage": stage}
        for rank, d in ((int(tele.src[fid]), "s"), (int(tele.dst[fid]), "r")):
            events.append({"ph": "X", "name": stage, "cat": "flow",
                           "pid": rank, "tid": _LANES[(nv, d)],
                           "ts": ts, "dur": dur, "args": args})

    segments, gaps = critical_path(tele)
    for s in segments:
        if s["finish"] > s["start"]:
            events.append({"ph": "X", "name": s["stage"], "cat": "critical",
                           "pid": cp_pid, "tid": 0, "ts": s["start"],
                           "dur": s["finish"] - s["start"],
                           "args": {"fid": s["fid"]}})
    for g in gaps:
        events.append({"ph": "X", "name": "stall:" + g["stage"],
                       "cat": "critical", "pid": cp_pid, "tid": 0,
                       "ts": g["t0"], "dur": g["t1"] - g["t0"],
                       "args": {"fid": g["fid"]}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"name": name, "algo": tele.algo,
                          "makespan": tele.makespan, "p": tele.p}}


def write_chrome_trace(tele: FlowTelemetry, path: str,
                       name: str = "allreduce") -> None:
    """Write the trace to `path` (open in chrome://tracing or Perfetto)."""
    with open(path, "w") as fh:
        json.dump(chrome_trace(tele, name=name), fh)
