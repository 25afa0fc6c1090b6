"""The traced part of a `--trace 1` run: torch.profiler over a few units of
work, recording the device and the CUDA runtime only, exported as a
Chrome trace and reduced here to device intervals, busy and idle time and
the breakdown of the result line.

Recording the host's operators as well made internlm2's traced training
steps 42 % longer than untraced ones (NVIDIA H100, 2.458 s against 1.734 s
for two steps), which would have read as device idle time; without them
the traced steps take about 3 % longer. So the trace holds no host
operator: an idle gap is named by the CUDA runtime call in flight, or
else by the device operation that ended it.

A trace is a list of events {"name", "cat", "ts", "dur"} in microseconds.
Device activity is the events of DEVICE_CATS; the traced window runs from
the first device or runtime event to the last one's end.
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = "cuda_runtime"
TRIES = 3          # captures to try when the profiler records no kernel


class Trace:
    def __init__(self, events: list):
        events = [e for e in events
                  if e.get("ph") == "X" and "ts" in e and "dur" in e]
        self.device = sorted((e for e in events
                              if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.runtime = sorted((e for e in events if e.get("cat") == RUNTIME),
                              key=lambda e: e["ts"])
        span = self.device + self.runtime
        self.t0 = min((e["ts"] for e in span), default=0.0)
        self.t1 = max((e["ts"] + e["dur"] for e in span), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_seconds(self, match) -> float:
        """Summed duration of the device events whose name `match` accepts."""
        return sum(e["dur"] for e in self.device if match(e["name"])) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device activity, as sorted disjoint [start, end]
        in microseconds."""
        merged = []
        for e in self.device:
            lo, hi = e["ts"], e["ts"] + e["dur"]
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        activity."""
        gaps, at = [], self.t0
        for lo, hi in self.busy_intervals():
            if lo > at:
                gaps.append((at, lo))
            at = max(at, hi)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def gap_names(self, gaps: list) -> list:
        """What the host was doing in each of the ascending `gaps`: the
        runtime call in flight at its middle, else the device operation
        that ended it (the host was preparing it)."""
        names, r, d = [], 0, 0
        for lo, hi in gaps:
            mid = (lo + hi) / 2
            while r < len(self.runtime) and \
                    self.runtime[r]["ts"] + self.runtime[r]["dur"] <= mid:
                r += 1
            while d < len(self.device) and self.device[d]["ts"] < hi:
                d += 1
            if r < len(self.runtime) and self.runtime[r]["ts"] <= mid:
                names.append(self.runtime[r]["name"])
            elif d < len(self.device):
                names.append("host, before " + self.device[d]["name"])
            else:
                names.append("host, after the last device operation")
        return names

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, each [[name, seconds]], at most `top`."""
        ops = {}
        for e in self.device:
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
        gaps = {}
        idle = self.idle_gaps()
        for (lo, hi), name in zip(idle, self.gap_names(idle)):
            gaps[name] = gaps.get(name, 0.0) + (hi - lo) * 1e-6
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k[:200], v] for k, v in rank(ops)],
                "idle_gaps": [[k[:200], v] for k, v in rank(gaps)]}


def capture(run_units, torch) -> Trace:
    """Profiles run_units() on the card and returns its trace; tries again
    (TRIES in all) when the profiler recorded no device activity. Without
    a card it records nothing and returns an empty trace."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        run_units()
        return Trace([])
    trace = Trace([])
    for _ in range(TRIES):
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_units()
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = Trace(json.load(fh)["traceEvents"])
        if trace.device:
            break
    return trace
