"""Struct-of-arrays flow representation + the vectorized simulator fast path.

The event loop in `core.simulator` costs ~20us per flow in Python; at the
p>=1024 scale of the paper's Section 4.3 claim a schedule has millions of
flows, so the sweep needs a fast path. For two schedule families the event
loop's behaviour is *forced*, which turns simulation into a max-plus
recurrence that numpy can evaluate in blocks:

  * ring with FIFO send sequencing (`core.ring`): every flow's start time is
    exactly max(release, finish[deps]) because the FIFO deps serialize each
    send port and each recv port only ever hears from one sender - the
    schedule is contention-free, so greedy dispatch cannot deviate;
  * slotted OptCC (`core.schedule._optcc_single_slotted`) under
    ``meta["port_inorder"]``: each port serves its flows in (pri, fid)
    order, so a flow starts exactly at max(release, finish[deps],
    finish[port predecessors]).

Generators that satisfy one of these contracts tag their schedules
``meta["vec_exact"] = True``; `simulate` then routes here, and
tests/test_torch_simulator.py enforces bit-identical results against
`simulate_reference` (same IEEE operations: max of the same operands, then
one addition - no reassociation anywhere).

The recurrence is evaluated in flow-graph order with adaptive blocking: a
block of consecutive flows can be computed in one numpy step iff none of
them depends (data dep or port predecessor) on a flow inside the block.
`maxsrc` (the latest in-edge per flow) makes the split point a vectorized
scan; structured schedules yield blocks of ~p flows, so the Python overhead
is O(num_flows / p).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.model import Schedule


@dataclasses.dataclass
class FlowArrays:
    """Columnar flow graph indexed by fid (fids must be 0..N-1).

    `pri` uses NaN for "unset" (fid order); `nv` marks NVLink flows.
    Dependencies are CSR: flow i's deps are
    ``dep_indices[dep_indptr[i]:dep_indptr[i+1]]``.
    """

    src: np.ndarray          # int64 [N]
    dst: np.ndarray          # int64 [N]
    size: np.ndarray         # float64 [N]
    release: np.ndarray      # float64 [N]
    pri: np.ndarray          # float64 [N], NaN = unset
    nv: np.ndarray           # bool [N]
    dep_indptr: np.ndarray   # int64 [N+1]
    dep_indices: np.ndarray  # int64 [nnz]

    @property
    def nflows(self) -> int:
        return len(self.size)

    @classmethod
    def from_schedule(cls, schedule: Schedule) -> "FlowArrays":
        """Convert Flow lists to arrays (fids must form a 0..N-1 range)."""
        nic, nv = schedule.nic_flows, schedule.nvlink_flows
        n = len(nic) + len(nv)
        src = np.empty(n, np.int64)
        dst = np.empty(n, np.int64)
        size = np.empty(n, np.float64)
        release = np.empty(n, np.float64)
        pri = np.empty(n, np.float64)
        nvf = np.zeros(n, bool)
        counts = np.zeros(n + 1, np.int64)
        seen = 0
        for flows, is_nv in ((nic, False), (nv, True)):
            for f in flows:
                i = f.fid
                if not 0 <= i < n:
                    raise ValueError(f"fid {i} outside 0..{n - 1}")
                src[i] = f.src
                dst[i] = f.dst
                size[i] = f.size
                release[i] = f.release
                pri[i] = np.nan if f.pri is None else f.pri
                nvf[i] = is_nv
                counts[i + 1] = len(f.deps)
                seen += 1
        if seen != n:
            raise ValueError("duplicate fids")
        indptr = np.cumsum(counts)
        indices = np.empty(indptr[-1], np.int64)
        for flows in (nic, nv):
            for f in flows:
                if f.deps:
                    a = indptr[f.fid]
                    indices[a:a + len(f.deps)] = f.deps
        return cls(src=src, dst=dst, size=size, release=release, pri=pri,
                   nv=nvf, dep_indptr=indptr, dep_indices=indices)


def _port_predecessors(order_pos: np.ndarray, port_id: np.ndarray,
                       pred: np.ndarray) -> None:
    """pred[pos] = previous position using the same port (wire flows only).

    `order_pos` are processing positions in increasing order; a stable sort
    by port id groups each port's flows while keeping that order, so the
    predecessor is just the previous element within each group.
    """
    o = np.argsort(port_id, kind="stable")
    ps = order_pos[o]
    ids = port_id[o]
    same = ids[1:] == ids[:-1]
    pred[ps[1:][same]] = ps[:-1][same]


def _segmented_finish(s: np.ndarray, sizes: np.ndarray, lmat: np.ndarray,
                      breaks: np.ndarray) -> np.ndarray:
    """Finish times of NIC wire flows under piecewise-constant rates.

    `s` are start times, `sizes` remaining-element budgets, `lmat[k, i]` the
    effective slowdown max(l_src, l_dst) of flow i during segment k, and
    `breaks` the segment boundaries (len(breaks) == lmat.shape[0] - 1).

    Mirrors the scalar event loops' re-timing arithmetic op-for-op: a flow
    finishing exactly at a breakpoint completes under the old rate (<= hi),
    a flow starting exactly at a breakpoint uses the new rate (strict
    t < hi), and partial segments carry ``rem = max(rem - (hi-t)/l, 0)``
    elements forward - that is what keeps vec and scalar runs bit-identical
    under timelines (tests/test_torch_simulator.py).
    """
    t = s.copy()
    rem = sizes.astype(np.float64).copy()
    fin = np.empty_like(t)
    done = np.zeros(len(t), bool)
    nseg = lmat.shape[0]
    for k in range(nseg):
        hi = float(breaks[k]) if k < nseg - 1 else np.inf
        l = lmat[k]
        act = ~done & (t < hi)
        cand = t + rem * l
        fdone = act & (cand <= hi)
        fin[fdone] = cand[fdone]
        done |= fdone
        part = act & ~fdone
        if part.any():
            rem[part] = np.maximum(rem[part] - (hi - t[part]) / l[part], 0.0)
            t[part] = hi
    return fin


def simulate_arrays(schedule: Schedule, telemetry: bool = False,
                    timeline=None):
    """Vectorized max-plus replay of a `vec_exact` schedule.

    Bit-identical to `simulate_reference` on eligible schedules: every start
    is the max of the same IEEE values the event loop would have observed,
    and every finish is the same single addition. ``telemetry=True``
    attaches a post-hoc `repro_torch.obs.FlowTelemetry` (timings unchanged).

    ``timeline=`` (a `repro_torch.core.model.FaultTimeline`) makes NIC rates
    piecewise-constant in time: the max-plus recurrence is unchanged (port
    service order is forced by the vec_exact contract, independent of
    durations), but each NIC wire flow's finish comes from
    `_segmented_finish` instead of one multiply-add. A timeline with no
    effective breakpoints degenerates to the static path bit-for-bit.
    """
    from repro_torch.core.simulator import SimResult   # circular at module load

    fa = schedule.arrays if schedule.arrays is not None \
        else FlowArrays.from_schedule(schedule)
    n = fa.nflows
    if n == 0:
        return SimResult(0.0, {}, {}, {})
    prof = schedule.profile
    tl_breaks: tuple = ()
    if timeline is not None:
        tl_breaks, tl_vecs = timeline.segments(prof)
        sl = np.asarray(tl_vecs[0], np.float64)
    else:
        sl = np.asarray(prof.slowdown, np.float64)
    tl_on = bool(tl_breaks)
    dur = fa.size * np.maximum(sl[fa.src], sl[fa.dst])
    if fa.nv.any():
        dur[fa.nv] = fa.size[fa.nv] / prof.nvlink_rate

    # Processing order: (pri, fid) with unset pri sorting last. For all-None
    # priorities (ring) this is fid order; for slotted schedules the wire
    # flows are slot-ordered and the zero-size self-stores (pri=None, no
    # dependents) come last. The order must be topological - verified below.
    has_pri = ~np.isnan(fa.pri)
    if has_pri.any():
        key = np.where(has_pri, fa.pri, np.inf)
        order = np.lexsort((np.arange(n), key))
    else:
        order = np.arange(n)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)

    rel_o = fa.release[order]
    dur_o = dur[order]
    wire_o = fa.size[order] > 0
    if tl_on:
        size_o = fa.size[order]
        # [nsegs, n] effective slowdown per segment in processing order.
        src_o, dst_o = fa.src[order], fa.dst[order]
        lmax_all = np.stack([
            np.maximum(np.asarray(v, np.float64)[src_o],
                       np.asarray(v, np.float64)[dst_o])
            for v in tl_vecs])
        seg_mask = wire_o & ~fa.nv[order]   # NIC wire flows get re-timed
        breaks_arr = np.asarray(tl_breaks, np.float64)

    # Dependency CSR re-indexed to processing positions.
    counts = np.diff(fa.dep_indptr)
    counts_o = counts[order]
    indptr_o = np.zeros(n + 1, np.int64)
    np.cumsum(counts_o, out=indptr_o[1:])
    nnz = int(indptr_o[-1])
    if nnz:
        gather = (np.repeat(fa.dep_indptr[order] - indptr_o[:-1], counts_o)
                  + np.arange(nnz))
        dep_pos = pos[fa.dep_indices[gather]]
    else:
        dep_pos = np.empty(0, np.int64)

    # Port predecessor links (wire flows only; zero-size flows bypass ports).
    spred = np.full(n, -1, np.int64)
    rpred = np.full(n, -1, np.int64)
    w = np.nonzero(wire_o)[0]
    if len(w):
        src_w = fa.src[order[w]]
        dst_w = fa.dst[order[w]]
        nv_w = fa.nv[order[w]].astype(np.int64)
        _port_predecessors(w, src_w * 4 + nv_w * 2, spred)
        _port_predecessors(w, dst_w * 4 + nv_w * 2 + 1, rpred)

    # Fuse data deps and port predecessors into one in-edge CSR: start =
    # max(release, finish[in-edges]) either way, and max is associative and
    # commutative over IEEE floats (no reassociation error), so one fused
    # reduceat is bit-identical to taking the maxima separately.
    extra = (spred >= 0).astype(np.int64) + (rpred >= 0)
    ecounts = counts_o + extra
    eptr = np.zeros(n + 1, np.int64)
    np.cumsum(ecounts, out=eptr[1:])
    enz = int(eptr[-1])
    esrc = np.empty(enz, np.int64)
    if nnz:
        gat = (np.repeat(eptr[:-1] - indptr_o[:-1], counts_o)
               + np.arange(nnz))
        esrc[gat] = dep_pos
    hs = spred >= 0
    esrc[(eptr[:-1] + counts_o)[hs]] = spred[hs]
    hr = rpred >= 0
    esrc[(eptr[:-1] + counts_o + hs)[hr]] = rpred[hr]

    # Latest in-edge per flow; also the topological-order check.
    maxsrc = np.full(n, -1, np.int64)
    ne_all = ecounts > 0
    if enz:
        maxsrc[ne_all] = np.maximum.reduceat(esrc, eptr[:-1][ne_all])
    if np.any(maxsrc >= np.arange(n)):
        raise RuntimeError(
            "schedule tagged vec_exact but its flow graph is not "
            "topologically ordered by (pri, fid); cannot vectorize")

    neg = -np.inf
    finish = np.empty(n, np.float64)
    start = np.empty(n, np.float64)
    i0 = 0
    scan = 1024     # boundary-scan chunk; blocks are usually ~p flows
    while i0 < n:
        # Find the largest i1 with all in-edges of [i0, i1) before i0.
        i1 = i0 + 1
        while i1 < n:
            hi = min(i1 + scan, n)
            conflicts = np.nonzero(maxsrc[i1:hi] >= i0)[0]
            if len(conflicts):
                i1 += int(conflicts[0])
                break
            i1 = hi
        b = slice(i0, i1)
        s = rel_o[b].copy()
        lo_ptr, hi_ptr = int(eptr[i0]), int(eptr[i1])
        if hi_ptr > lo_ptr:
            vals = finish[esrc[lo_ptr:hi_ptr]]
            ne = ne_all[b]
            off = np.minimum(eptr[i0:i1] - lo_ptr, len(vals) - 1)
            edge_max = np.maximum.reduceat(vals, off)
            np.maximum(s, np.where(ne, edge_max, neg), out=s)
        start[b] = s
        fb = s + dur_o[b]
        if tl_on:
            mb = np.nonzero(seg_mask[b])[0]
            if len(mb):
                fb[mb] = _segmented_finish(s[mb], size_o[b][mb],
                                           lmax_all[:, i0:i1][:, mb],
                                           breaks_arr)
        finish[b] = fb
        i0 = i1

    makespan = float(finish.max())

    def materialize():
        start_d = dict(zip(order.tolist(), start.tolist()))
        finish_d = dict(zip(order.tolist(), finish.tolist()))
        busy: dict[tuple, float] = {}
        kinds = np.where(fa.nv[order], "nv", "nic")
        # Under a timeline the wire occupancy is the realized finish-start
        # span, not the segment-0 duration.
        eff_dur = (finish - start) if tl_on else dur_o
        for i in w.tolist():
            k = str(kinds[i])
            d = float(eff_dur[i])
            a, b_ = int(fa.src[order[i]]), int(fa.dst[order[i]])
            busy[(k, a, "s")] = busy.get((k, a, "s"), 0.0) + d
            busy[(k, b_, "r")] = busy.get((k, b_, "r"), 0.0) + d
        return start_d, finish_d, busy

    res = SimResult(makespan, lazy=materialize)
    if telemetry:
        from repro_torch.core.simulator import _attach_telemetry
        res = _attach_telemetry(schedule, res)
    return res
