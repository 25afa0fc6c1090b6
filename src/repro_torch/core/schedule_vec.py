"""Vectorized (array-program) schedule generators for the sweep hot path.

These build the *same* flow graphs as `core.ring` / `core.schedule` - same
fids, sources, destinations, sizes, dependencies, priorities and releases -
but as columnar `core.flowvec.FlowArrays` instead of per-flow `Flow`
objects. Constructing a Flow dataclass costs ~10us; at sweep scale (10^5-10^6
flows per scenario) object construction dominates schedule generation, so
the hot path never materializes flows at all: the returned `Schedule` has
empty `nic_flows` and `schedule.arrays` set, which both simulator fast paths
consume directly.

Bit-equality with the scalar generators is enforced by
tests/test_torch_schedules.py: `FlowArrays.from_schedule(scalar)`
must equal the arrays built here, field for field. Section sizes come from
the same `split_points` calls (one per segment - a k-iteration loop, not a
hot path) so integer rounding is identical; priority/release arithmetic
follows the scalar expressions' exact association, so the floats are
identical too.

The generators fall back to the scalar path for the shapes it special-cases
(ph < 4 legacy ordering, empty sections from extreme rounding): the
returned schedule is then Flow-based and the simulator converts on demand.
Semantics tags (`vec_exact`, `port_inorder`) follow `core.schedule`:
ring and the l <= 2 slotted construction are exact max-plus systems;
everything else keeps greedy event-loop semantics (served by the optimized
greedy loop in `core.simulator`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.flowvec import FlowArrays
from repro_torch.core.model import STAGE_ID, BandwidthProfile, Schedule
from repro_torch.core.ring import ring_allreduce_schedule, split_points
from repro_torch.core.schedule import (optcc_multi_gpu_schedule,
                                 optcc_multi_schedule, optcc_single_schedule)


def ring_arrays(profile: BandwidthProfile, n: int) -> Schedule:
    """Columnar twin of `ring.ring_allreduce_schedule`.

    fid layout (round-major, matching the scalar generator):
      RS round t, rank r      -> fid t*p + r            (t in [0, p-1))
      self-store, rank r      -> fid (p-1)*p + r
      AG round t, rank r      -> fid p*p + t*p + r
    FIFO deps (rank's previous wire send) and chunk-delivery deps are the
    closed forms of the scalar loop's `last_recv`/`last_send` bookkeeping.
    """
    p = profile.p
    if p < 2:
        raise ValueError("need p >= 2")
    bounds = split_points(n, p)
    csz = np.diff(bounds).astype(np.float64)    # chunk sizes
    N = (2 * p - 1) * p
    src = np.empty(N, np.int64)
    dst = np.empty(N, np.int64)
    size = np.empty(N, np.float64)
    t = np.arange(p - 1)[:, None]               # rounds
    r = np.arange(p)[None, :]                   # ranks
    nxt = (r + 1) % p

    # Reduce-scatter: rank r sends chunk (r - t) mod p to r+1.
    rs = (t * p + r).ravel()
    src[rs] = np.broadcast_to(r, (p - 1, p)).ravel()
    dst[rs] = np.broadcast_to(nxt, (p - 1, p)).ravel()
    size[rs] = csz[((r - t) % p).ravel()]
    # Self-stores: chunk (r+1) mod p completed at r by RS round p-2.
    ss = (p - 1) * p + np.arange(p)
    src[ss] = dst[ss] = np.arange(p)
    size[ss] = 0.0
    # Allgather: rank r sends chunk (r + 1 - t) mod p to r+1.
    ag = (p * p + t * p + r).ravel()
    src[ag] = src[rs]
    dst[ag] = dst[rs]
    size[ag] = csz[((r + 1 - t) % p).ravel()]

    # Dependencies. RS t=0: none. RS t>0: chunk delivery (t-1, r-1) + FIFO
    # (t-1, r). Self-store: delivery (p-2, r-1). AG t=0: self-store + FIFO
    # (RS p-2, r). AG t>0: delivery (AG t-1, r-1) + FIFO (AG t-1, r).
    counts = np.empty(N, np.int64)
    counts[rs] = np.where(np.broadcast_to(t > 0, (p - 1, p)), 2, 0).ravel()
    counts[ss] = 1
    counts[ag] = 2
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int64)
    prv = (r - 1) % p
    if p > 2:
        t1 = np.arange(1, p - 1)[:, None]
        rs1 = (t1 * p + r).ravel()
        base = indptr[rs1]
        indices[base] = ((t1 - 1) * p + prv).ravel()
        indices[base + 1] = ((t1 - 1) * p + r).ravel()
    indices[indptr[ss]] = (p - 2) * p + (np.arange(p) - 1) % p
    ag0 = p * p + np.arange(p)
    indices[indptr[ag0]] = ss
    indices[indptr[ag0] + 1] = (p - 2) * p + np.arange(p)
    if p > 2:
        t1 = np.arange(1, p - 1)[:, None]
        ag1 = (p * p + t1 * p + r).ravel()
        base = indptr[ag1]
        indices[base] = (p * p + (t1 - 1) * p + prv).ravel()
        indices[base + 1] = (p * p + (t1 - 1) * p + r).ravel()

    fa = FlowArrays(src=src, dst=dst, size=size,
                    release=np.zeros(N), pri=np.full(N, np.nan),
                    nv=np.zeros(N, bool), dep_indptr=indptr,
                    dep_indices=indices)
    stage_ids = np.empty(N, np.int16)
    stage_ids[: (p - 1) * p] = STAGE_ID["RS"]
    stage_ids[(p - 1) * p: p * p] = STAGE_ID["SELF"]
    stage_ids[p * p:] = STAGE_ID["AG"]
    return Schedule(profile=profile, n=n, nic_flows=[], arrays=fa,
                    meta={"algo": "ring", "topology": "ring", "p": p,
                          "vec_exact": True, "stage_ids": stage_ids})


def optcc_single_arrays(profile: BandwidthProfile, n: int, k: int,
                        fill_bubbles: bool = True,
                        slot_release: bool = True) -> Schedule:
    """Columnar twin of `schedule._optcc_single_slotted`.

    fid layout per segment m (matching the scalar generator exactly):
      pass 1, section j:  ph-1 S1 chain hops, then the merged S2 upload
                          -> fids seg_start[m] + j*ph + [0, ph)
      star self-store     -> fid seg_start[m] + ph*ph      (fill segments)
      pass 2, section j:  S3 download, straggler self-store, ph-1 S4 hops
                          -> fids p2[m] + j*(ph+1) + [0, ph+1)
    """
    p = profile.p
    (s_rank,) = profile.stragglers
    ell = profile.slowdown[s_rank]
    ph = p - 1
    if ph < 4:
        return optcc_single_schedule(profile, n, k, fill_bubbles)
    healthy = np.array([x for x in range(p) if x != s_rank], np.int64)

    fill = fill_bubbles and ell < 2.0 and k >= 2
    if fill:
        ring_frac = ell * ph / ((p - 2) * ell + 2.0)
        ring_n = int(round(n * ring_frac))
    else:
        ring_n = n
    seg_bounds = split_points(ring_n, k)
    star_bounds = split_points(n - ring_n, max(k - 1, 1)) + ring_n
    s_i = ring_n / (k * ph) if ring_n else 1.0
    w = max(ell, 2.0)
    B = w * ph * s_i

    sec_sz = np.empty((k, ph), np.int64)
    for m in range(k):
        sec_sz[m] = np.diff(split_points(
            int(seg_bounds[m + 1] - seg_bounds[m]), ph))
    if (sec_sz <= 0).any():
        return optcc_single_schedule(profile, n, k, fill_bubbles)
    c = np.zeros(k, np.int64)                    # star block size, segment m
    if fill:
        c[:k - 1] = np.diff(star_bounds)[:k - 1]
    star = (c > 0).astype(np.int64)              # star self-store present?
    pc = np.concatenate(([0], c[:-1]))           # previous block size

    seg_len = ph * ph + star + ph * (ph + 1)
    seg_start = np.zeros(k + 1, np.int64)
    np.cumsum(seg_len, out=seg_start[1:])
    N = int(seg_start[-1])
    p2 = seg_start[:-1] + ph * ph + star         # pass-2 base per segment

    src = np.empty(N, np.int64)
    dst = np.empty(N, np.int64)
    size = np.empty(N, np.float64)
    pri = np.full(N, np.nan)
    counts = np.empty(N, np.int64)

    mm = np.arange(k)[:, None, None]             # segment      (k,1,1)
    jj = np.arange(ph)[None, :, None]            # section      (1,ph,1)
    tt = np.arange(ph - 1)[None, None, :]        # hop          (1,1,ph-1)
    nu = (jj + mm) % ph                          # owner index  (k,ph,1)
    sec3 = sec_sz[:, :, None]

    # --- pass 1: S1 chains ---------------------------------------------
    f1 = seg_start[:-1][:, None, None] + jj * ph + tt
    src[f1.ravel()] = healthy[(nu + 1 + tt) % ph].ravel()
    dst[f1.ravel()] = healthy[(nu + 2 + tt) % ph].ravel()
    size[f1.ravel()] = np.broadcast_to(sec3, f1.shape).ravel()
    pri[f1.ravel()] = (mm * B + (2 * nu + ph) * s_i + tt * s_i).ravel()
    counts[f1.ravel()] = np.broadcast_to(tt > 0, f1.shape).ravel()
    # --- pass 1: merged S2 uploads --------------------------------------
    f2 = (seg_start[:-1][:, None] + np.arange(ph)[None, :] * ph + ph - 1)
    nu2 = nu[:, :, 0]
    src[f2.ravel()] = healthy[nu2].ravel()
    dst[f2.ravel()] = s_rank
    size[f2.ravel()] = (sec_sz + c[:, None]).ravel()
    if ell <= 2.0:
        s2pri = (mm[:, :, 0] + 1) * B + (2 * nu2 + 2 * ph - 2) * s_i
    else:
        s2pri = (mm[:, :, 0] + 1) * B + ell * nu2 * s_i
    pri[f2.ravel()] = s2pri.ravel()
    counts[f2.ravel()] = 1
    # --- star self-store -------------------------------------------------
    fstar = seg_start[:-1] + ph * ph             # valid where star[m]
    sm = np.nonzero(star)[0]
    src[fstar[sm]] = dst[fstar[sm]] = s_rank
    size[fstar[sm]] = 0.0
    counts[fstar[sm]] = ph
    # --- pass 2: S3 downloads -------------------------------------------
    f3 = p2[:, None] + np.arange(ph)[None, :] * (ph + 1)
    src[f3.ravel()] = s_rank
    dst[f3.ravel()] = healthy[nu2].ravel()
    size[f3.ravel()] = (sec_sz + pc[:, None]).ravel()
    if ell <= 2.0:
        s3pri = (mm[:, :, 0] + 2) * B + (2 * nu2 + 2 * ph - 4) * s_i
    else:
        s3pri = (mm[:, :, 0] + 2) * B + ell * nu2 * s_i
    pri[f3.ravel()] = s3pri.ravel()
    counts[f3.ravel()] = np.broadcast_to(1 + ph * (pc[:, None] > 0),
                                         (k, ph)).ravel()
    # --- pass 2: straggler self-stores ----------------------------------
    fss = f3 + 1
    src[fss.ravel()] = dst[fss.ravel()] = s_rank
    size[fss.ravel()] = 0.0
    counts[fss.ravel()] = 1
    # --- pass 2: S4 allgather chains ------------------------------------
    f4 = f3[:, :, None] + 2 + tt
    src[f4.ravel()] = healthy[(nu + tt) % ph].ravel()
    dst[f4.ravel()] = healthy[(nu + 1 + tt) % ph].ravel()
    size[f4.ravel()] = np.broadcast_to(sec3, f4.shape).ravel()
    pri[f4.ravel()] = ((mm + 3) * B + (2 * nu + 2 * ph - 3) * s_i
                       + tt * s_i).ravel()
    counts[f4.ravel()] = 1

    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int64)
    # chained flows (S1 t>0, S2): dep = fid - 1
    chained = f1[:, :, 1:].ravel()
    indices[indptr[chained]] = chained - 1
    indices[indptr[f2.ravel()]] = f2.ravel() - 1
    # star: all of the segment's S2 fids, section order
    if len(sm):
        indices[indptr[fstar[sm]][:, None]
                + np.arange(ph)[None, :]] = f2[sm]
    # S3: own S2 first, then the previous segment's S2 fids when a star
    # block is being returned
    indices[indptr[f3.ravel()]] = f2.ravel()
    pm = np.nonzero(pc > 0)[0]
    if len(pm):
        f3p = f3[pm].ravel()
        prev_ups = np.repeat(f2[pm - 1], ph, axis=0)
        indices[indptr[f3p][:, None] + 1 + np.arange(ph)[None, :]] = prev_ups
    # straggler self-store: own S2; S4 first hop: the S3 (fid - 2)
    indices[indptr[fss.ravel()]] = f2.ravel()
    f40 = f4[:, :, 0].ravel()
    indices[indptr[f40]] = f40 - 2
    s4rest = f4[:, :, 1:].ravel()
    indices[indptr[s4rest]] = s4rest - 1

    release = np.where(np.isnan(pri), 0.0, pri) if slot_release \
        else np.zeros(N)
    fa = FlowArrays(src=src, dst=dst, size=size, release=release, pri=pri,
                    nv=np.zeros(N, bool), dep_indptr=indptr,
                    dep_indices=indices)
    stage_ids = np.empty(N, np.int16)
    stage_ids[f1.ravel()] = STAGE_ID["S1"]
    stage_ids[f2.ravel()] = STAGE_ID["S2"]
    stage_ids[fstar[sm]] = STAGE_ID["SELF"]
    stage_ids[f3.ravel()] = STAGE_ID["S3"]
    stage_ids[fss.ravel()] = STAGE_ID["SELF"]
    stage_ids[f4.ravel()] = STAGE_ID["S4"]
    meta = {"algo": "optcc-single", "topology": "optcc", "k": k, "ell": ell,
            "fill": fill, "slotted": True, "stage_ids": stage_ids}
    if ell <= 2:          # see _optcc_single_slotted for why l > 2 is greedy
        meta["port_inorder"] = True
        meta["vec_exact"] = True
    return Schedule(profile=profile, n=n, nic_flows=[], arrays=fa, meta=meta)


def optcc_multi_arrays(profile: BandwidthProfile, n: int, k: int) -> Schedule:
    """Columnar twin of `schedule.optcc_multi_schedule`.

    Every (segment, section) block has the same internal dependency pattern
    (uploads, reduce chain, owner store, allgather chain, downloads), so the
    block is built once as a *template* of relative fids / rotation offsets
    and broadcast over all k*ph blocks; only sizes and the owner rotation
    vary per block.
    """
    p = profile.p
    stragglers = list(profile.stragglers)
    m = len(stragglers)
    healthy = np.array([x for x in range(p) if x not in set(stragglers)],
                       np.int64)
    ph = p - m
    if ph < 2:
        raise ValueError("need at least 2 healthy GPUs")

    seg_bounds = split_points(n, k)
    sec_sz = np.empty((k, ph), np.int64)
    for seg in range(k):
        sec_sz[seg] = np.diff(split_points(
            int(seg_bounds[seg + 1] - seg_bounds[seg]), ph))
    if (sec_sz <= 0).any():
        return optcc_multi_schedule(profile, n, k)

    # Block template: one entry per flow, fids relative to the block base.
    # rot: healthy-index offset from the owner rotation (nu = oidx + rot);
    # -1 means the endpoint is a fixed straggler rank (s_end).
    L = 2 * m + 2 * ph - 1
    rot_src = np.zeros(L, np.int64)
    rot_dst = np.zeros(L, np.int64)
    s_src = np.full(L, -1, np.int64)     # fixed src rank (stragglers), or -1
    s_dst = np.full(L, -1, np.int64)
    zero_sz = np.zeros(L, bool)
    rel_deps: list[list[int]] = [[] for _ in range(L)]
    for i in range(m):                   # uploads
        s_src[i] = stragglers[i]
        rot_dst[i] = 1 + (i % ph)
    for t in range(ph - 1):              # reduce chain
        e = m + t
        rot_src[e] = 1 + t
        rot_dst[e] = 2 + t
        if t > 0:
            rel_deps[e].append(e - 1)
        rel_deps[e].extend(i for i in range(m) if i % ph == t)
    e_self = m + ph - 1                  # owner self-store
    rot_src[e_self] = rot_dst[e_self] = 0
    zero_sz[e_self] = True
    ready = [m + ph - 2] + [i for i in range(m) if i % ph == ph - 1]
    rel_deps[e_self] = list(ready)
    for t in range(ph - 1):              # allgather chain
        e = m + ph + t
        rot_src[e] = t
        rot_dst[e] = t + 1
        rel_deps[e] = list(ready) if t == 0 else [e - 1]
    for i in range(m):                   # downloads
        e = m + 2 * ph - 1 + i
        rot_src[e] = 1 + (i % (ph - 1))
        s_dst[e] = stragglers[i]
        rel_deps[e] = [m + ph + (i % (ph - 1))]

    # Broadcast the template over all (seg, j) blocks.
    nblk = k * ph
    oidx = ((np.arange(ph)[None, :] + np.arange(k)[:, None]) % ph).ravel()
    bases = np.arange(nblk)[:, None] * L
    src = np.where(s_src >= 0, s_src,
                   healthy[(oidx[:, None] + rot_src) % ph]).ravel()
    dst = np.where(s_dst >= 0, s_dst,
                   healthy[(oidx[:, None] + rot_dst) % ph]).ravel()
    size = np.where(zero_sz, 0.0,
                    sec_sz.reshape(-1, 1).astype(np.float64)).ravel()
    rel_counts = np.array([len(d) for d in rel_deps], np.int64)
    rel_flat = np.array([d for ds in rel_deps for d in ds], np.int64)
    N = nblk * L
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(np.broadcast_to(rel_counts, (nblk, L)).ravel(),
              out=indptr[1:])
    indices = (rel_flat[None, :] + bases).ravel()

    fa = FlowArrays(src=src, dst=dst, size=size,
                    release=np.zeros(N), pri=np.full(N, np.nan),
                    nv=np.zeros(N, bool), dep_indptr=indptr,
                    dep_indices=indices)
    # Stage tags follow the template layout (ordering-B flavour: uploads=S3,
    # reduce chain=S1, allgather=S4, downloads=S2), tiled over all blocks.
    tmpl_stage = np.empty(L, np.int16)
    tmpl_stage[:m] = STAGE_ID["S3"]
    tmpl_stage[m:m + ph - 1] = STAGE_ID["S1"]
    tmpl_stage[m + ph - 1] = STAGE_ID["SELF"]
    tmpl_stage[m + ph:m + 2 * ph - 1] = STAGE_ID["S4"]
    tmpl_stage[m + 2 * ph - 1:] = STAGE_ID["S2"]
    return Schedule(profile=profile, n=n, nic_flows=[], arrays=fa,
                    meta={"algo": "optcc-multi", "topology": "optcc",
                          "k": k, "m": m,
                          "stage_ids": np.tile(tmpl_stage, nblk)})


def optcc_multi_gpu_arrays(profile: BandwidthProfile, n: int,
                           k: int) -> Schedule:
    """Columnar twin of `schedule.optcc_multi_gpu_schedule`.

    Like `optcc_multi_arrays`, every (cycle, segment, section) block has a
    fixed internal pattern - here one of *two* templates, since segments
    alternate ordering A (S1-S2-S3-S4) and ordering B (S3-S1-S4-S2). A
    template entry encodes each endpoint as (server-selector, local-index):
    the server is an absolute index (N1/N3 collects), the straggler server,
    or a rotation off the owner index into healthy servers; the local index
    selects from the cycle's collect order (lead last). rel deps are block-
    internal, so the CSR is a broadcast of the template over block bases.
    """
    p, g = profile.p, profile.gpus_per_server
    q = p // g
    if q < 3:
        raise ValueError("need q >= 3 servers")
    if g == 1:
        return optcc_multi_gpu_schedule(profile, n, k)
    sserver = None
    for j in range(q):
        if profile.slowdown[j * g] > 1.0:
            sserver = j
    assert sserver is not None, "no straggler server in profile"
    ell = profile.slowdown[sserver * g]
    healthy_srv = np.array([j for j in range(q) if j != sserver], np.int64)
    qh = q - 1

    part_bounds = split_points(n, g)
    sec_sz = np.empty((g, k, qh), np.int64)
    for cyc in range(g):
        c_lo = int(part_bounds[cyc])
        seg_bounds = split_points(int(part_bounds[cyc + 1]) - c_lo, k)
        for seg in range(k):
            sec_sz[cyc, seg] = np.diff(split_points(
                int(seg_bounds[seg + 1] - seg_bounds[seg]), qh))
    if (sec_sz <= 0).any():
        return optcc_multi_gpu_schedule(profile, n, k)

    # Template encoding. Endpoint = (server selector, local index):
    #   selector >= 0  absolute server (the N1/N3 collect loop),
    #   selector == -1 healthy_srv[(oidx + rot) % qh]  (owner rotation),
    #   selector == -2 the straggler server;
    # rank = server*g + lr[cyc][li], where lr = collect order (lead last).
    # Dep = (dyn, v): dyn=0 -> relative fid v; dyn=1 -> last collect hop of
    # healthy_srv[(oidx + v) % qh], i.e. that server's fold dependency -
    # the only block-varying references (collect chains sit at fixed
    # relative fids srv*(g-1).., but *which* one a rotated hop folds in
    # depends on oidx).
    LEAD = g - 1

    class _Tmpl:
        def __init__(self):
            self.rows: list[tuple] = []   # (nv, ssel, srot, sli,
            self.deps: list[list] = []    #  dsel, drot, dli, zero)
            self.stages: list[int] = []   # stage tag per row

        def add(self, nv, ssel, srot, sli, dsel, drot, dli, zero, deps,
                stage="SELF"):
            self.rows.append((nv, ssel, srot, sli, dsel, drot, dli, zero))
            self.deps.append(list(deps))
            self.stages.append(STAGE_ID[stage])
            return len(self.rows) - 1

        def nv_chain(self, sel, rot, reverse, first_deps, stage):
            """g-1 NVLink hops: collect order, or distribute (reversed)."""
            last = None
            for t in range(g - 1):
                sli, dli = (t, t + 1) if not reverse \
                    else (g - 1 - t, g - 2 - t)
                deps = list(first_deps) if last is None else [(0, last)]
                last = self.add(True, sel, rot, sli, sel, rot, dli,
                                False, deps, stage=stage)
            return last

    coll_last = lambda srv: srv * (g - 1) + g - 2   # rel fid of N1/N3 end
    s_coll = (0, coll_last(sserver))                # straggler's collect

    def build(ordering_a: bool) -> _Tmpl:
        T = _Tmpl()
        for srv in range(q):                        # N1/N3 collects
            T.nv_chain(srv, 0, False, (),
                       stage="N3" if srv == sserver else "N1")
        if ordering_a:
            last = None
            for t in range(qh - 1):                 # S1 over healthy leads
                deps = ([] if last is None else [(0, last)]) + [(1, 1 + t)]
                last = T.add(False, -1, 1 + t, LEAD, -1, 2 + t, LEAD,
                             False, deps, stage="S1")
            s2 = T.add(False, -1, qh, LEAD, -2, 0, LEAD, False,
                       [(0, last), (1, qh)], stage="S2")  # owner->straggler
            down = [(0, s2), s_coll]
            s3 = T.add(False, -2, 0, LEAD, -1, qh, LEAD, False, down,
                       stage="S3")
            T.add(False, -2, 0, LEAD, -2, 0, LEAD, True, down)
            T.nv_chain(-2, 0, True, down, stage="N2")   # on straggler srv
            ag = []
            for t in range(qh - 1):                 # S4 over healthy leads
                deps = [(0, s3)] if t == 0 else [(0, ag[-1])]
                ag.append(T.add(False, -1, t, LEAD, -1, t + 1, LEAD,
                                False, deps, stage="S4"))
            T.nv_chain(-1, 0, True, [(0, s3)], stage="N4")  # at the owner
            for t in range(1, qh):
                T.nv_chain(-1, t, True, [(0, ag[t - 1])], stage="N4")
        else:
            # Ordering B: straggler uploads raw first; chain is
            # [s_lead] + healthy leads rot 0..qh-1.
            last = T.add(False, -2, 0, LEAD, -1, 0, LEAD, False, [s_coll],
                         stage="S3")
            for t in range(1, qh):
                last = T.add(False, -1, t - 1, LEAD, -1, t, LEAD, False,
                             [(0, last), (1, t - 1)], stage="S1")
            own = [(0, last), (1, qh - 1)]
            T.add(False, -1, qh - 1, LEAD, -1, qh - 1, LEAD, True, own)
            ag = []
            for t in range(qh - 1):                 # allgather from owner
                deps = own if t == 0 else [(0, ag[-1])]
                ag.append(T.add(False, -1, qh - 1 + t, LEAD,
                                -1, qh + t, LEAD, False, deps, stage="S4"))
            s2p = T.add(False, -1, 2 * qh - 2, LEAD, -2, 0, LEAD, False,
                        [(0, ag[-1])], stage="S2")  # final return
            T.nv_chain(-1, qh - 1, True, own, stage="N4")  # at the owner
            for t in range(1, qh):
                T.nv_chain(-1, qh - 1 + t, True, [(0, ag[t - 1])],
                           stage="N4")
            T.nv_chain(-2, 0, True, [(0, s2p)], stage="N2")
        return T

    tmpl = {True: build(True), False: build(False)}
    lr_arr = np.array([[r for r in range(g) if r != cyc] + [cyc]
                       for cyc in range(g)], np.int64)

    # Block bases over the (cyc, seg, j) grid (C order, matching the scalar
    # generator's loop nest).
    LA, LB = len(tmpl[True].rows), len(tmpl[False].rows)
    seg_is_a = (np.arange(k) % 2 == 0)
    blk_len = np.where(seg_is_a, LA, LB)[None, :, None]
    blk_len = np.broadcast_to(blk_len, (g, k, qh))
    bases = np.zeros(g * k * qh + 1, np.int64)
    np.cumsum(blk_len.ravel(), out=bases[1:])
    N = int(bases[-1])
    bases3 = bases[:-1].reshape(g, k, qh)
    oidx2 = (np.arange(qh)[None, :] + np.arange(k)[:, None]) % qh  # (k, qh)

    src = np.empty(N, np.int64)
    dst = np.empty(N, np.int64)
    size = np.empty(N, np.float64)
    nv = np.empty(N, bool)
    counts = np.empty(N, np.int64)
    stage_ids = np.empty(N, np.int16)

    per_ord = {}
    for a in (True, False):
        T = tmpl[a]
        rows = np.array(T.rows, np.int64)       # (L, 8)
        dcounts = np.array([len(d) for d in T.deps], np.int64)
        dflat = np.array([dv for ds in T.deps for dv in ds],
                         np.int64).reshape(-1, 2) if any(T.deps) else \
            np.zeros((0, 2), np.int64)
        segs = np.nonzero(seg_is_a == a)[0]
        base_b = bases3[:, segs, :].ravel()     # (nb,)
        oidx_b = np.broadcast_to(oidx2[segs], (g, len(segs), qh)).ravel()
        cyc_b = np.broadcast_to(np.arange(g)[:, None, None],
                                (g, len(segs), qh)).ravel()
        sz_b = sec_sz[:, segs, :].ravel().astype(np.float64)
        L = len(rows)
        fids = base_b[:, None] + np.arange(L)[None, :]

        def endpoint(sel, rot, li):
            srv = np.where(sel >= 0, sel,
                           np.where(sel == -1,
                                    healthy_srv[(oidx_b[:, None] + rot)
                                                % qh], sserver))
            return srv * g + lr_arr[cyc_b[:, None], li[None, :]]

        src[fids] = endpoint(rows[:, 1], rows[:, 2], rows[:, 3])
        dst[fids] = endpoint(rows[:, 4], rows[:, 5], rows[:, 6])
        size[fids] = np.where(rows[:, 7] == 1, 0.0, sz_b[:, None])
        nv[fids] = (rows[:, 0] == 1)
        counts[fids] = dcounts
        stage_ids[fids] = np.array(T.stages, np.int16)[None, :]
        per_ord[a] = (base_b, oidx_b, dcounts, dflat, fids)

    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int64)
    for a in (True, False):
        base_b, oidx_b, dcounts, dflat, fids = per_ord[a]
        nnz_b = int(dcounts.sum())
        if nnz_b == 0:
            continue
        dyn = dflat[:, 0] == 1
        v = dflat[:, 1]
        dyn_rel = (healthy_srv[(oidx_b[:, None] + v) % qh] * (g - 1)
                   + g - 2)
        rel = np.where(dyn, dyn_rel, v)
        pos = indptr[base_b][:, None] + np.arange(nnz_b)[None, :]
        indices[pos] = base_b[:, None] + rel

    fa = FlowArrays(src=src, dst=dst, size=size,
                    release=np.zeros(N), pri=np.full(N, np.nan),
                    nv=nv, dep_indptr=indptr, dep_indices=indices)
    return Schedule(profile=profile, n=n, nic_flows=[], arrays=fa,
                    meta={"algo": "optcc-multigpu", "topology": "optcc",
                          "k": k, "g": g, "ell": ell,
                          "stage_ids": stage_ids})


def optcc_schedule_arrays(profile: BandwidthProfile, n: int, k: int = 16,
                          fill_bubbles: bool = True) -> Schedule:
    """Arrays-first twin of `schedule.optcc_schedule` (same dispatch)."""
    stragglers = profile.stragglers
    if not stragglers:
        return ring_arrays(profile, n)
    if profile.gpus_per_server > 1:
        return optcc_multi_gpu_arrays(profile, n, k)
    if len(stragglers) == 1:
        return optcc_single_arrays(profile, n, k, fill_bubbles)
    return optcc_multi_arrays(profile, n, k)
