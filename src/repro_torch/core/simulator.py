"""Deterministic discrete-event simulator for the bandwidth-bound flow model.

This is our stand-in for SimAI (the paper's NS-3-based simulator), restricted
to exactly the model in which the paper's theory lives (Section 3):

  * each rank has one NIC with a send port and a recv port; each port carries
    at most one flow at a time (the paper's non-overlap constraint, 4.1);
  * a NIC flow src->dst of `size` elements takes size * max(l_src, l_dst)
    time units (the slow endpoint throttles the wire);
  * NVLink flows (multi-GPU/server setting) use separate per-rank NVLink
    send/recv ports at (g-1)x the NIC rate and are never degraded;
  * zero-size flows are local bookkeeping (self-stores), not wire traffic:
    they complete the moment their dependencies do and never occupy a port;
  * flows start as soon as (a) all declared dependencies have completed and
    (b) both ports are free; among competing ready flows, the lower fid wins
    (fid encodes the schedule's priority order);
  * schedules tagged ``meta["port_inorder"]`` (the slotted OptCC
    construction) serve every port strictly in (pri, fid) order - a NIC
    executing its transmit queue in schedule order - instead of the greedy
    opportunistic dispatch arbitrary dependency graphs get.

The same run always produces the same result (no randomness), matching the
paper's "SimAI is deterministic" setup.

Two implementations produce bit-identical results (enforced by
tests/test_torch_simulator.py):

  * `simulate_reference` - the scalar event loop below, the semantics oracle;
  * the vectorized fast path in `core.flowvec` for schedules whose meta
    carries ``vec_exact: True`` (ring with FIFO sequencing, slotted OptCC):
    for those graphs port service order is forced, so completion times are
    the least fixed point of a max-plus recurrence evaluated in numpy blocks.

`simulate` dispatches to the fast path when it is provably exact and falls
back to the event loop for arbitrary dependency graphs (legacy/multi/
multi-GPU schedules, hand-built tests).
"""
from __future__ import annotations

import heapq
import os
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.model import (BandwidthProfile, FaultTimeline, Flow,
                              Schedule)


class SimResult:
    """Simulation outcome. `start`/`finish`/`port_busy` are materialized
    lazily: the sweep hot path only reads `makespan`, and building
    100k-entry dicts per scenario would dominate the vectorized fast path.
    """

    __slots__ = ("makespan", "_start", "_finish", "_port_busy", "_lazy",
                 "telemetry")

    def __init__(self, makespan: float,
                 start: Optional[dict] = None,
                 finish: Optional[dict] = None,
                 port_busy: Optional[dict] = None,
                 lazy: Optional[Callable[[], tuple]] = None,
                 telemetry=None):
        self.makespan = makespan
        self._start = start
        self._finish = finish
        self._port_busy = port_busy
        self._lazy = lazy
        # repro_torch.obs.FlowTelemetry when the run was asked for it, else None.
        # Attached post-hoc by `simulate(..., telemetry=True)`; never read
        # (or written) by any timing path.
        self.telemetry = telemetry

    def _materialize(self) -> None:
        if self._lazy is not None:
            self._start, self._finish, self._port_busy = self._lazy()
            self._lazy = None

    @property
    def start(self) -> dict[int, float]:
        self._materialize()
        return self._start

    @property
    def finish(self) -> dict[int, float]:
        self._materialize()
        return self._finish

    @property
    def port_busy(self) -> dict[tuple, float]:
        # {(kind, rank, dir): time}, for utilization analysis
        self._materialize()
        return self._port_busy

    def utilization(self, kind: str, rank: int, direction: str) -> float:
        if self.makespan == 0:
            return 0.0
        return self.port_busy.get((kind, rank, direction), 0.0) / self.makespan

    def __reduce__(self):
        # Closures don't pickle; materialize before crossing process
        # boundaries (simulate_many with workers > 0).
        return (SimResult,
                (self.makespan, self.start, self.finish, self.port_busy,
                 None, self.telemetry))


def _flow_duration(flow: Flow, profile: BandwidthProfile, kind: str) -> float:
    if kind == "nv":
        assert profile.gpus_per_server > 1, \
            "NVLink flows require gpus_per_server > 1"
        return flow.size / profile.nvlink_rate
    return flow.size * max(profile.slowdown[flow.src], profile.slowdown[flow.dst])


def _attach_telemetry(schedule: Schedule, result: "SimResult") -> "SimResult":
    """Derive per-flow telemetry from an already-finished run (opt-in).

    Post-hoc by design: the timings in `result` were produced by exactly
    the same code path telemetry-off runs use, so enabling telemetry cannot
    perturb a single bit of any simulated time.
    """
    from repro_torch import obs      # deliberate late import: obs is opt-in
    result.telemetry = obs.collect(schedule, result)
    return result


def simulate(schedule: Schedule, telemetry: bool = False,
             timeline: Optional[FaultTimeline] = None) -> SimResult:
    """Run the schedule to completion; returns makespan and per-flow times.

    Dispatches to the vectorized fast path when the schedule certifies it is
    exact for its structure (``meta["vec_exact"]``), else runs the scalar
    reference event loop. Both paths agree bit-for-bit on eligible
    schedules (tests/test_torch_simulator.py).

    With ``timeline=`` the run honors a `FaultTimeline`: per-rank NIC rates
    are piecewise-constant in time, in-flight flows are re-timed at every
    breakpoint (remaining elements carry over at the new rate), and flows
    starting after a breakpoint use the rates then in force. A timeline
    whose effective slowdown vector never changes after t=0 degenerates to
    the static run of `timeline.profile_at(schedule.profile, 0)` -
    bit-for-bit, because the timeline machinery is skipped entirely. The
    `vec_exact` fast path stays exact under timelines: forced port order is
    a structural property, so only the finish arithmetic changes (a
    segmented pass mirroring the event loops op-for-op; equality pinned by
    tests/test_torch_simulator.py).

    With ``telemetry=True`` the result additionally carries a
    `repro_torch.obs.FlowTelemetry` (``result.telemetry``) derived from the same
    start/finish times - timings are identical either way.

    With ``REPRO_DEBUG`` set in the environment, the schedule's meta is
    checked against the documented key contract
    (`model.validate_schedule_meta`) before simulating.
    """
    if os.environ.get("REPRO_DEBUG"):
        from repro_torch.core.model import validate_schedule_meta
        validate_schedule_meta(schedule)
    if schedule.meta.get("vec_exact"):
        from repro_torch.core import flowvec
        res = flowvec.simulate_arrays(schedule, timeline=timeline)
    else:
        res = _simulate_greedy_fast(schedule, timeline=timeline)
    return _attach_telemetry(schedule, res) if telemetry else res


def _simulate_greedy_fast(schedule: Schedule,
                          timeline: Optional[FaultTimeline] = None
                          ) -> SimResult:
    """Greedy event loop over columnar arrays: identical semantics and
    results to `simulate_reference`, ~3x faster (int ports, precomputed
    durations and priorities, no per-flow dataclass traffic). Used for the
    schedules whose dispatch is genuinely dynamic (multi-straggler,
    multi-GPU, hand-built graphs); bit-equality with the reference loop is
    enforced by tests/test_torch_simulator.py (static and timelines).

    Timeline semantics: at each breakpoint every in-flight NIC wire flow is
    re-timed - remaining elements = rem - elapsed/l_old, new finish =
    now + rem * l_new - and its queued finish event goes stale (skipped on
    pop via a finish-time match). NVLink flows are never degraded and are
    never re-timed; zero-size flows hold no ports and finish instantly.
    """
    from repro_torch.core import flowvec

    fa = schedule.arrays if schedule.arrays is not None \
        else flowvec.FlowArrays.from_schedule(schedule)
    n = fa.nflows
    if n == 0:
        return SimResult(0.0, {}, {}, {})
    profile = schedule.profile
    if fa.nv.any():
        assert profile.gpus_per_server > 1, \
            "NVLink flows require gpus_per_server > 1"
    tl_breaks: tuple = ()
    if timeline is not None:
        tl_breaks, tl_vecs = timeline.segments(profile)
        sl = np.asarray(tl_vecs[0], np.float64)
    else:
        sl = np.asarray(profile.slowdown, np.float64)
    tl_on = bool(tl_breaks)
    dur_a = fa.size * np.maximum(sl[fa.src], sl[fa.dst])
    if fa.nv.any():
        dur_a[fa.nv] = fa.size[fa.nv] / profile.nvlink_rate
    nv4 = fa.nv.astype(np.int64)
    # Hot per-element access wants plain Python lists, not numpy scalars.
    dur = dur_a.tolist()
    size = fa.size.tolist()
    release = fa.release.tolist()
    sport = (fa.src * 4 + nv4 * 2).tolist()
    rport = (fa.dst * 4 + nv4 * 2 + 1).tolist()
    # Fast-heap mode: with no priorities and no releases (multi/multi-GPU
    # and most hand-built graphs), (pri, fid) order *is* fid order, so the
    # waiting heaps can hold plain ints and release wake-ups never happen.
    simple = bool(np.isnan(fa.pri).all()) and not fa.release.any()
    pri_key = np.where(np.isnan(fa.pri), np.arange(n, dtype=np.float64),
                       fa.pri).tolist()
    dep_counts = np.diff(fa.dep_indptr)
    ndeps = dep_counts.tolist()
    nports = 4 * profile.p
    # Reverse adjacency (dependents) as CSR, built vectorized: group dep
    # edges by their target fid, keeping each edge's owning row.
    nnz = len(fa.dep_indices)
    if nnz:
        if (fa.dep_indices < 0).any() or (fa.dep_indices >= n).any():
            bad = fa.dep_indices[(fa.dep_indices < 0)
                                 | (fa.dep_indices >= n)][0]
            raise ValueError(f"flow depends on unknown fid {int(bad)}")
        rows = np.repeat(np.arange(n, dtype=np.int64), dep_counts)
        grp = np.argsort(fa.dep_indices, kind="stable")
        dep_rows = rows[grp].tolist()
        dptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(fa.dep_indices, minlength=n), out=dptr[1:])
        dptr = dptr.tolist()
    else:
        dep_rows = []
        dptr = [0] * (n + 1)

    # Strict in-order port service (slotted schedules). Statically the
    # slotted layout is collision-free, so greedy dispatch coincides with
    # in-order service and this never triggers - but under a timeline the
    # rates shift mid-run and opportunistic dispatch would deviate from the
    # reference loop, so the check must be real here too.
    inorder = bool(schedule.meta.get("port_inorder"))
    port_head = [0] * nports
    port_seq: list[list[int]] = [[] for _ in range(nports)]
    if inorder:
        for fid in sorted(range(n), key=lambda i: (pri_key[i], i)):
            if size[fid] > 0:
                port_seq[sport[fid]].append(fid)
                port_seq[rport[fid]].append(fid)

    port_free = [True] * nports
    waiting: list[list] = [[] for _ in range(nports)]
    port_busy = [0.0] * nports
    started = [False] * n
    woken = [False] * n
    start_t = [0.0] * n
    finish_t = [0.0] * n
    # Event kinds: 0 = flow finish, 1 = release wake-up, 2 = rate change
    # (fid then indexes the timeline breakpoint).
    events: list[tuple[float, int, int, int]] = []
    seq = 0
    now = 0.0
    nfinished = 0
    push = heapq.heappush
    pop = heapq.heappop

    if tl_on:
        # Per-segment effective slowdown per flow (NIC wire flows only) +
        # in-flight re-timing state. `fdone` guards against stale finish
        # events re-finishing a re-timed flow.
        lmax_segs = [np.maximum(np.asarray(v, np.float64)[fa.src],
                                np.asarray(v, np.float64)[fa.dst]).tolist()
                     for v in tl_vecs]
        nicw = ((fa.size > 0) & ~fa.nv).tolist()
        rem = [0.0] * n
        tbase = [0.0] * n
        lcur = [0.0] * n
        fdone = [False] * n
        inflight: set[int] = set()
        seg_idx = 0
        for j, bt in enumerate(tl_breaks):
            push(events, (bt, seq, j, 2))
            seq += 1

    def try_start(fid: int) -> bool:
        nonlocal seq
        if started[fid]:
            return True
        if not simple and release[fid] > now:
            if not woken[fid]:
                woken[fid] = True
                push(events, (release[fid], seq, fid, 1))
                seq += 1
            return False
        if size[fid] <= 0:
            started[fid] = True
            start_t[fid] = finish_t[fid] = now
            push(events, (now, seq, fid, 0))
            seq += 1
            return True
        sp, rp = sport[fid], rport[fid]
        if not (port_free[sp] and port_free[rp]):
            return False
        if inorder and (port_seq[sp][port_head[sp]] != fid
                        or port_seq[rp][port_head[rp]] != fid):
            return False
        port_free[sp] = port_free[rp] = False
        if inorder:
            port_head[sp] += 1
            port_head[rp] += 1
        started[fid] = True
        if tl_on and nicw[fid]:
            l = lmax_segs[seg_idx][fid]
            d = size[fid] * l
            rem[fid] = size[fid]
            tbase[fid] = now
            lcur[fid] = l
            inflight.add(fid)
        else:
            d = dur[fid]
        start_t[fid] = now
        finish_t[fid] = now + d
        port_busy[sp] += d
        port_busy[rp] += d
        push(events, (now + d, seq, fid, 0))
        seq += 1
        return True

    def enqueue_ready(fid: int) -> None:
        if try_start(fid):
            return
        entry = fid if simple else (pri_key[fid], fid)
        push(waiting[sport[fid]], entry)
        push(waiting[rport[fid]], entry)

    if simple:
        order0 = range(n)
    else:
        order0 = sorted(range(n), key=lambda i: (pri_key[i], i))
    for fid in order0:
        if ndeps[fid] == 0:
            enqueue_ready(fid)

    while events:
        now = events[0][0]
        done_batch: list[int] = []
        wake_batch: list[int] = []
        rate_batch: list[int] = []
        while events and events[0][0] == now:
            _, _, fid, kind = pop(events)
            if kind == 0:
                if tl_on:
                    if fdone[fid] or finish_t[fid] != now:
                        continue        # stale event from before a re-time
                    fdone[fid] = True
                done_batch.append(fid)
            elif kind == 1:
                wake_batch.append(fid)
            else:
                rate_batch.append(fid)
        newly_ready: list[int] = []
        freed_ports: list[int] = []
        for fid in done_batch:
            nfinished += 1
            if tl_on:
                inflight.discard(fid)
            if size[fid] > 0:
                sp, rp = sport[fid], rport[fid]
                port_free[sp] = port_free[rp] = True
                freed_ports.append(sp)
                freed_ports.append(rp)
            for j in range(dptr[fid], dptr[fid + 1]):
                dep = dep_rows[j]
                ndeps[dep] -= 1
                if ndeps[dep] == 0:
                    newly_ready.append(dep)
        for bidx in rate_batch:
            # Rates change at `now` *after* flows finishing exactly at `now`
            # complete (zero remaining work) and *before* any flow starts at
            # `now` (new arrivals see the new rates). Every in-flight NIC
            # wire flow is re-timed with the carried-over remainder; the
            # same arithmetic, in the same order, as flowvec's segmented
            # pass - that is what keeps vec and scalar runs bit-identical.
            seg_idx = bidx + 1
            lm = lmax_segs[seg_idx]
            for fid in sorted(inflight):
                r = max(rem[fid] - (now - tbase[fid]) / lcur[fid], 0.0)
                l_new = lm[fid]
                rem[fid] = r
                tbase[fid] = now
                lcur[fid] = l_new
                newf = now + r * l_new
                if newf != finish_t[fid]:
                    delta = newf - finish_t[fid]
                    port_busy[sport[fid]] += delta
                    port_busy[rport[fid]] += delta
                    finish_t[fid] = newf
                    push(events, (newf, seq, fid, 0))
                    seq += 1
        for fid in wake_batch:
            if not started[fid] and ndeps[fid] == 0:
                woken[fid] = False
                try_start(fid)
        if newly_ready:
            if simple:
                newly_ready.sort()
            else:
                newly_ready.sort(key=lambda i: (pri_key[i], i))
            for fid in newly_ready:
                enqueue_ready(fid)
        for port in freed_ports:
            q = waiting[port]
            blocked: list = []
            while q and port_free[port]:
                entry = pop(q)
                cand = entry if simple else entry[1]
                if started[cand]:
                    continue
                if not try_start(cand):
                    blocked.append(entry)
            for entry in blocked:
                push(q, entry)

    if nfinished != n:
        stuck = [fid for fid in range(n)
                 if ndeps[fid] > 0 or not started[fid]]
        raise RuntimeError(
            f"deadlock: {len(stuck)}/{n} flows never ran, e.g. "
            f"{sorted(stuck)[:5]}")
    makespan = max(finish_t) if n else 0.0

    def materialize():
        start_d = dict(enumerate(start_t))
        finish_d = dict(enumerate(finish_t))
        busy: dict[tuple, float] = {}
        for pid, b in enumerate(port_busy):
            if b > 0.0:
                kind = "nv" if pid & 2 else "nic"
                busy[(kind, pid // 4, "r" if pid & 1 else "s")] = b
        return start_d, finish_d, busy

    return SimResult(makespan, lazy=materialize)


def simulate_reference(schedule: Schedule,
                       telemetry: bool = False,
                       timeline: Optional[FaultTimeline] = None) -> SimResult:
    """Scalar discrete-event loop: the semantics oracle for `simulate`.

    Honors a `FaultTimeline` with the same semantics as the fast paths
    (piecewise-constant NIC rates; in-flight flows carry their remaining
    elements across breakpoints at the new rate); tests/test_torch_simulator.py pins
    bit-equality against both.
    """
    profile = schedule.profile
    tl_breaks: tuple = ()
    if timeline is not None:
        tl_breaks, tl_vecs = timeline.segments(profile)
        sl = list(tl_vecs[0])
    else:
        sl = list(profile.slowdown)
    tl_on = bool(tl_breaks)
    flows: dict[int, tuple[Flow, str]] = {}
    for f in schedule.nic_flows:
        flows[f.fid] = (f, "nic")
    for f in schedule.nvlink_flows:
        if f.fid in flows:
            raise ValueError(f"duplicate fid {f.fid}")
        flows[f.fid] = (f, "nv")

    # Dependency bookkeeping.
    ndeps: dict[int, int] = {}
    dependents: dict[int, list[int]] = {}
    for fid, (f, _) in flows.items():
        cnt = 0
        for d in f.deps:
            if d not in flows:
                raise ValueError(f"flow {fid} depends on unknown fid {d}")
            cnt += 1
            dependents.setdefault(d, []).append(fid)
        ndeps[fid] = cnt

    # Ports: (kind, rank, "s"/"r") -> free?  plus waiting heaps per port.
    port_free: dict[tuple, bool] = {}
    waiting: dict[tuple, list[int]] = {}
    port_busy: dict[tuple, float] = {}

    def ports_of(fid: int) -> tuple[tuple, tuple]:
        f, kind = flows[fid]
        return (kind, f.src, "s"), (kind, f.dst, "r")

    for fid in flows:
        for port in ports_of(fid):
            port_free.setdefault(port, True)
            waiting.setdefault(port, [])

    def prio(fid: int) -> tuple[float, int]:
        return flows[fid][0].priority

    # Strict in-order port service (slotted schedules): each port's wire
    # flows may only start in (pri, fid) order - the NIC drains its transmit
    # queue in schedule order instead of opportunistically.
    inorder = bool(schedule.meta.get("port_inorder"))
    port_head: dict[tuple, int] = {}
    port_seq: dict[tuple, list[int]] = {}
    if inorder:
        for fid in sorted(flows, key=prio):
            if flows[fid][0].size <= 0:
                continue
            for port in ports_of(fid):
                port_seq.setdefault(port, []).append(fid)
        port_head = {port: 0 for port in port_seq}

    started: set[int] = set()
    finished: set[int] = set()
    woken: set[int] = set()
    start_t: dict[int, float] = {}
    finish_t: dict[int, float] = {}
    # (time, seq, fid, kind); kind 0 = finish, 1 = release wake-up,
    # 2 = rate change (fid indexes the timeline breakpoint).
    events: list[tuple[float, int, int, int]] = []
    seq = 0
    now = 0.0

    # Timeline re-timing state (NIC wire flows in flight only).
    seg_idx = 0
    rem: dict[int, float] = {}
    tbase: dict[int, float] = {}
    lcur: dict[int, float] = {}
    inflight: set[int] = set()

    def push_event(t: float, fid: int, kind: int) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, fid, kind))
        seq += 1

    if tl_on:
        for j, bt in enumerate(tl_breaks):
            push_event(bt, j, 2)

    def try_start(fid: int) -> bool:
        if fid in started:
            return True
        f, kind = flows[fid]
        if f.release > now:
            if fid not in woken:
                woken.add(fid)
                push_event(f.release, fid, 1)
            return False
        if f.size <= 0:
            # Bookkeeping flow (self-store): no wire traffic, no ports.
            started.add(fid)
            start_t[fid] = finish_t[fid] = now
            push_event(now, fid, 0)
            return True
        sp, rp = ports_of(fid)
        if not (port_free[sp] and port_free[rp]):
            return False
        if inorder and (port_seq[sp][port_head[sp]] != fid
                        or port_seq[rp][port_head[rp]] != fid):
            return False
        port_free[sp] = port_free[rp] = False
        if inorder:
            port_head[sp] += 1
            port_head[rp] += 1
        started.add(fid)
        if kind == "nv":
            dur = f.size / profile.nvlink_rate
        else:
            l = max(sl[f.src], sl[f.dst])
            dur = f.size * l
            if tl_on:
                rem[fid] = f.size
                tbase[fid] = now
                lcur[fid] = l
                inflight.add(fid)
        start_t[fid] = now
        finish_t[fid] = now + dur
        port_busy[sp] = port_busy.get(sp, 0.0) + dur
        port_busy[rp] = port_busy.get(rp, 0.0) + dur
        push_event(now + dur, fid, 0)
        return True

    def enqueue_ready(fid: int) -> None:
        # Try to start immediately; if blocked, wait on both ports.
        if try_start(fid):
            return
        sp, rp = ports_of(fid)
        heapq.heappush(waiting[sp], (prio(fid), fid))
        heapq.heappush(waiting[rp], (prio(fid), fid))

    for fid in sorted(flows, key=prio):
        if ndeps[fid] == 0:
            enqueue_ready(fid)

    while events:
        now = events[0][0]
        done_batch: list[int] = []
        wake_batch: list[int] = []
        rate_batch: list[int] = []
        # Pop every event at `now` (simultaneous completions/wakes/rates).
        while events and events[0][0] == now:
            _, _, fid, kind = heapq.heappop(events)
            if kind == 0:
                if tl_on:
                    if fid in finished or finish_t.get(fid) != now:
                        continue        # stale event from before a re-time
                done_batch.append(fid)
            elif kind == 1:
                wake_batch.append(fid)
            else:
                rate_batch.append(fid)
        newly_ready: list[int] = []
        freed_ports: list[tuple] = []
        for fid in done_batch:
            finished.add(fid)
            if tl_on:
                inflight.discard(fid)
            if flows[fid][0].size > 0:       # zero flows never held ports
                sp, rp = ports_of(fid)
                port_free[sp] = port_free[rp] = True
                freed_ports.extend((sp, rp))
            for dep in dependents.get(fid, ()):  # release dependents
                ndeps[dep] -= 1
                if ndeps[dep] == 0:
                    newly_ready.append(dep)
        for bidx in rate_batch:
            # Rates change at `now` *after* flows finishing exactly at `now`
            # complete and *before* any flow starts at `now` — identical
            # ordering and arithmetic to _simulate_greedy_fast / flowvec so
            # all three paths stay bit-identical.
            seg_idx = bidx + 1
            sl = list(tl_vecs[seg_idx])
            for fid in sorted(inflight):
                f = flows[fid][0]
                r = max(rem[fid] - (now - tbase[fid]) / lcur[fid], 0.0)
                l_new = max(sl[f.src], sl[f.dst])
                rem[fid] = r
                tbase[fid] = now
                lcur[fid] = l_new
                newf = now + r * l_new
                if newf != finish_t[fid]:
                    delta = newf - finish_t[fid]
                    sp, rp = ports_of(fid)
                    port_busy[sp] += delta
                    port_busy[rp] += delta
                    finish_t[fid] = newf
                    push_event(newf, fid, 0)
        for fid in wake_batch:
            if fid not in started and ndeps[fid] == 0:
                woken.discard(fid)
                try_start(fid)
        for fid in sorted(newly_ready, key=prio):
            enqueue_ready(fid)
        # Freed ports may admit waiting flows. Admission is work-conserving:
        # if the highest-priority waiter is blocked on its *other* port we
        # try lower-priority waiters (this is what packs bubble-filling
        # flows into straggler-link gaps). Entries for already-started flows
        # are skipped lazily.
        for port in freed_ports:
            q = waiting[port]
            blocked: list[tuple] = []
            while q and port_free[port]:
                entry = heapq.heappop(q)
                cand = entry[1]
                if cand in started:
                    continue
                if not try_start(cand):
                    blocked.append(entry)
            for entry in blocked:
                heapq.heappush(q, entry)

    if len(finished) != len(flows):
        stuck = [fid for fid in flows if fid not in finished]
        raise RuntimeError(
            f"deadlock: {len(stuck)}/{len(flows)} flows never ran, e.g. "
            f"{sorted(stuck)[:5]}")
    makespan = max(finish_t.values(), default=0.0)
    res = SimResult(makespan=makespan, start=start_t, finish=finish_t,
                    port_busy=port_busy)
    return _attach_telemetry(schedule, res) if telemetry else res


def simulate_many(schedules: Sequence[Schedule] | Iterable[Schedule],
                  workers: int = 0) -> list[SimResult]:
    """Simulate a batch of schedules, preserving input order.

    workers == 0 runs serially in-process; workers > 0 fans the batch out
    over a process pool (schedules are pickled to the workers, so this pays
    off only when per-schedule simulation dominates serialization — large
    flow graphs). Results are identical either way: the simulator is
    deterministic and each schedule is independent.
    """
    return map_scenarios(simulate, list(schedules), workers=workers)


def map_scenarios(fn: Callable, items: Sequence, workers: int = 0) -> list:
    """Order-preserving map used by the sweep engine: `fn` must be a
    module-level picklable callable. workers == 0 -> serial; the serial path
    is also the fallback when a pool cannot be spawned (sandboxes without
    /dev/shm or fork support)."""
    items = list(items)
    if workers <= 0 or len(items) <= 1:
        return [fn(x) for x in items]
    try:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(fn, items, chunksize=max(1, len(items) // (8 * workers))))
    except (OSError, BrokenProcessPool):
        # Pool creation failed, or workers were killed mid-map (seccomp,
        # rlimits). fn is pure/deterministic, so re-running serially is safe.
        return [fn(x) for x in items]
