"""OptCC schedule construction (Section 4, Appendices C, D, E).

Closed-form O(p k) generation, no solver - suitable for online re-planning
(the paper reports < 1 ms at p=1024; chip_smoke.py's `schedules` phase times it).

Three generators:
  * optcc_single_schedule     - one straggler, one GPU/server (Sec 4.1-4.3),
                                with Appendix-C bubble filling for l < 2;
  * optcc_multi_schedule      - m stragglers, one GPU/server (Appendix D);
  * optcc_multi_gpu_schedule  - one straggler server, g GPUs/server (App E),
                                with NVLink N-phases around every NIC stage.

Stage orderings (Section 4.1): segments alternate between
  ordering A:  S1 -> S2 -> S3 -> S4   (healthy reduce-scatter first, straggler
               receives the healthy partial sum, folds its own, sends back)
  ordering B:  S3 -> S1 -> S4 -> S2   (straggler uploads its raw contribution
               first; the healthy ring folds it during reduce-scatter; the
               result returns to the straggler last)
Patterns C/D are A/B with rotated section ownership (the paper's offset);
rotation happens implicitly through per-segment owner rotation here.

The simulator's port-exclusive, priority-ordered greedy dispatch turns these
dependency graphs into the paper's pipelined timeline; fids encode schedule
priority (segment-major). Timing is validated against Eq. (1)/(2), D.3 and
E.4 in the JAX package's schedule-time tests; data correctness in
tests/test_torch_executor.py via core.executor.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.model import STAGE_ID, BandwidthProfile, Flow, Op, Schedule
from repro_torch.core.ring import ring_allreduce_schedule, split_points


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------

class _FlowList:
    """Flow accumulator handing out monotonically increasing fids.

    Every flow carries a pipeline-stage tag (model.STAGE_NAMES) recorded in
    fid order; the finished array lands in ``Schedule.meta["stage_ids"]``
    for the observability layer. Tags are metadata only - the simulator's
    timing paths never read them.
    """

    def __init__(self):
        self.nic: list[Flow] = []
        self.nv: list[Flow] = []
        self.stages: list[int] = []

    def add(self, src, dst, size, deps, lo, hi, op, key, nvlink=False,
            pri=None, extra=(), stage="SELF") -> int:
        fid = len(self.nic) + len(self.nv)
        f = Flow(fid=fid, src=src, dst=dst, size=float(size),
                 deps=tuple(deps), lo=lo, hi=hi, op=op, key=key, pri=pri,
                 extra=tuple(extra))
        (self.nv if nvlink else self.nic).append(f)
        self.stages.append(STAGE_ID[stage])
        return fid

    def stage_ids(self) -> np.ndarray:
        return np.asarray(self.stages, np.int16)


def _ring_chain(fl: _FlowList, nodes: list[int], lo: int, hi: int, key: tuple,
                first_deps=(), per_node_deps=None, pri0=None, pri_step=0.0,
                nvlink=False, stage="S1") -> int:
    """ACCUM chain nodes[0] -> nodes[1] -> ... -> nodes[-1]; returns last fid.

    per_node_deps: optional {node_rank: [extra fids]} added to the *outgoing*
    flow of that node (used to fold straggler uploads / NVLink collects in
    before a node forwards). pri0/pri_step: slotted priorities per hop.
    stage: one tag for every hop, or a per-hop sequence (ordering-B chains
    start with the straggler's S3 upload, then continue as S1 hops).
    """
    last = None
    per_hop = not isinstance(stage, str)
    for t, (a, b) in enumerate(zip(nodes[:-1], nodes[1:])):
        deps = list(first_deps) if last is None else [last]
        if per_node_deps:
            deps.extend(per_node_deps.get(a, ()))
        pri = None if pri0 is None else pri0 + t * pri_step
        last = fl.add(a, b, hi - lo, deps, lo, hi, Op.ACCUM, key, pri=pri,
                      nvlink=nvlink, stage=stage[t] if per_hop else stage)
    return last


def _store_chain(fl: _FlowList, nodes: list[int], lo: int, hi: int, key: tuple,
                 first_deps=(), pri0=None, pri_step=0.0,
                 nvlink=False, stage="S4") -> list[int]:
    """STORE forward chain; returns fids (one per hop)."""
    fids, last = [], None
    for t, (a, b) in enumerate(zip(nodes[:-1], nodes[1:])):
        deps = list(first_deps) if last is None else [last]
        pri = None if pri0 is None else pri0 + t * pri_step
        last = fl.add(a, b, hi - lo, deps, lo, hi, Op.STORE, key, pri=pri,
                      nvlink=nvlink, stage=stage)
        fids.append(last)
    return fids


# ----------------------------------------------------------------------------
# single straggler, one GPU per server (Section 4)
# ----------------------------------------------------------------------------

def optcc_single_schedule(profile: BandwidthProfile, n: int, k: int,
                          fill_bubbles: bool = True,
                          alternate_orderings: bool = False,
                          slot_release: bool = True) -> Schedule:
    """Single straggler, one GPU/server.

    Default path (`_optcc_single_slotted`): an exact, provably collision-free
    slotted construction equivalent to the paper's four-pattern overlay
    (Figures 5-7). In units of the ideal section size s' and with ph = p-1:

      * S1 (reduce-scatter) of segment m: section j's chain staggered to
        start at offset 2j of body m, hop t at offset 2j+t; sender of hop t
        is healthy[(j+m+1+t) mod ph].
      * S2 of segment m (merged with the Appendix-C star-upload when l<2,
        so the wire flow lasts exactly one 2s' slot): offset
        ((2j+ph-4) mod 2ph) of body m+1.
      * S3 (merged with the star-download): offset ((2j+ph-6) mod 2ph) of
        body m+2.
      * S4 (allgather): section j's chain starts at offset
        ((2j+ph-9) mod 2ph) of body m+3, sender of hop t is
        healthy[(j+m+t) mod ph].

    For every healthy send port with phase g = (rank_index - body) mod ph,
    the S1 cells {2j + ((g-1-j) mod ph)}, the S4 cells
    {2j+ph-9 + ((g+3-j) mod ph)} and the 2-cell straggler window
    [2g+ph-2, 2g+ph) tile the body circle [0, 2ph) exactly (verified for
    all ph in tests); receive ports tile by the shift symmetry
    recv(port a) = send(port a-1). Hence zero steady-state bubbles - the
    schedule achieves Eq. (1)/(2) up to the 4-body pipeline head/tail.

    With `alternate_orderings=True` (or ph < 4), the legacy generator is
    used: segments alternate the paper's ordering A (S1-S2-S3-S4) and
    ordering B (S3-S1-S4-S2); correct and pattern-faithful but relies on
    greedy dispatch, so it carries a few percent of scheduling slack.
    """
    if alternate_orderings or profile.p - 1 < 4:
        return _optcc_single_legacy(profile, n, k, fill_bubbles,
                                    alternate_orderings)
    return _optcc_single_slotted(profile, n, k, fill_bubbles, slot_release)


def _optcc_single_slotted(profile: BandwidthProfile, n: int, k: int,
                          fill_bubbles: bool, slot_release: bool) -> Schedule:
    """Exact zero-bubble construction (see optcc_single_schedule docstring).

    All times in units of the ideal section size s'; body B = w*ph with
    w = max(l, 2). Everything is keyed on the *owner index*
    nu = (j + m) mod ph, which makes each port's per-body occupancy pattern
    independent of the segment index m - the property that lets per-body
    cell sets tile exactly (cells spilling into the next body are replaced
    by the previous segment's identical pattern):

      port alpha send:  S1 cells [2a, 2a+ph-2] | S4 [2a+ph-1, 2a+2ph-3]
                        | S2 window [2a+2ph-2, 2a+2ph-1]   (a = 2*alpha)
      port alpha recv:  shift symmetry recv(alpha) = send(alpha-1)
      straggler recv:   S2 slots {2nu-2 mod 2ph}  (tile)
      straggler send:   S3 slots {2nu-4 mod 2ph}  (tile)

    For l < 2, S2/S3 are *enlarged* (Appendix C) with the star-block chunk
    so each wire flow lasts exactly one 2-cell slot; S2(m) uploads star
    block m, S3(m) returns star block m-1 (k-1 blocks total).
    """
    import dataclasses

    p = profile.p
    (s_rank,) = profile.stragglers
    ell = profile.slowdown[s_rank]
    healthy = [r for r in range(p) if r != s_rank]
    ph = p - 1

    fill = fill_bubbles and ell < 2.0 and k >= 2
    if fill:
        ring_frac = ell * ph / ((p - 2) * ell + 2.0)
        ring_n = int(round(n * ring_frac))
    else:
        ring_n = n
    seg_bounds = split_points(ring_n, k)
    # k-1 star blocks: block m is uploaded with segment m's S2 flows and
    # downloaded with segment m+1's S3 flows.
    star_bounds = split_points(n - ring_n, max(k - 1, 1)) + ring_n
    s_i = ring_n / (k * ph) if ring_n else 1.0
    w = max(ell, 2.0)
    B = w * ph * s_i

    def slot2(m, nu):   # S2 upload slot (straggler recv)
        if ell <= 2.0:
            return ((m + 1) * B + (2 * nu + 2 * ph - 2) * s_i)
        return (m + 1) * B + ell * nu * s_i

    def slot3(m, nu):   # S3 download slot (straggler send)
        if ell <= 2.0:
            return ((m + 2) * B + (2 * nu + 2 * ph - 4) * s_i)
        return (m + 2) * B + ell * nu * s_i

    fl = _FlowList()
    prev_ups: list[int] = []
    prev_block: tuple[int, int] = (0, 0)
    for m in range(k):
        sec_bounds = split_points(int(seg_bounds[m + 1] - seg_bounds[m]), ph) \
            + int(seg_bounds[m])
        if fill and m < k - 1:
            blo, bhi = int(star_bounds[m]), int(star_bounds[m + 1])
        else:
            blo = bhi = 0
        c = bhi - blo
        # Pass 1: S1 chains + merged S2 uploads (star block m).
        s1_of: list = [None] * ph
        s2_of: list = [None] * ph
        for j in range(ph):
            lo, hi = int(sec_bounds[j]), int(sec_bounds[j + 1])
            if hi <= lo:
                continue
            key = ("sec", m, j)
            nu = (j + m) % ph
            owner = healthy[nu]
            chain = [healthy[(nu + 1 + t) % ph] for t in range(ph)]
            s1_of[j] = _ring_chain(fl, chain, lo, hi, key,
                                   pri0=m * B + (2 * nu + ph) * s_i,
                                   pri_step=s_i)
            extra = ((blo, bhi, Op.ACCUM, ("star", m)),) if c > 0 else ()
            s2_of[j] = fl.add(owner, s_rank, (hi - lo) + c, [s1_of[j]],
                              lo, hi, Op.ACCUM, key,
                              pri=slot2(m, nu), extra=extra, stage="S2")
        ups = [f for f in s2_of if f is not None]
        if c > 0 and ups:
            # straggler's own star-block output (local, zero wire time).
            fl.add(s_rank, s_rank, 0.0, ups, blo, bhi, Op.STORE, ("star", m))
        # Pass 2: merged S3 downloads (star block m-1) + S4 + self-stores.
        pblo, pbhi = prev_block
        pc = pbhi - pblo
        for j in range(ph):
            if s2_of[j] is None:
                continue
            lo, hi = int(sec_bounds[j]), int(sec_bounds[j + 1])
            key = ("sec", m, j)
            nu = (j + m) % ph
            owner = healthy[nu]
            extra = ((pblo, pbhi, Op.STORE, ("star", m - 1)),) if pc else ()
            deps3 = [s2_of[j]] + (prev_ups if pc else [])
            s3 = fl.add(s_rank, owner, (hi - lo) + pc, deps3, lo, hi,
                        Op.STORE, key, pri=slot3(m, nu), extra=extra,
                        stage="S3")
            # straggler's own section output.
            fl.add(s_rank, s_rank, 0.0, [s2_of[j]], lo, hi, Op.STORE, key)
            ag = [healthy[(nu + t) % ph] for t in range(ph)]
            _store_chain(fl, ag, lo, hi, key, first_deps=[s3],
                         pri0=(m + 3) * B + (2 * nu + 2 * ph - 3) * s_i,
                         pri_step=s_i)
        prev_ups, prev_block = ups, (blo, bhi)

    # Tail: the last star block (k-2) was returned by segment k-1's S3;
    # all blocks are closed. (Block indices run 0..k-2.)
    flows = fl.nic
    if slot_release:
        flows = [dataclasses.replace(f, release=(f.pri or 0.0))
                 for f in flows]
    meta = {"algo": "optcc-single", "topology": "optcc", "k": k, "ell": ell,
            "fill": fill, "slotted": True, "stage_ids": fl.stage_ids()}
    # For l <= 2 the body tiling is exactly collision-free, so forcing every
    # port to serve its flows strictly in (pri, fid) order (port_inorder: a
    # NIC draining its transmit queue in schedule order, what a real proxy
    # thread does) costs nothing and makes completion times an exact
    # max-plus recurrence, hence vec_exact (core.flowvec). For l > 2 the
    # slot layout keeps its w=2 Stage-1/4 offsets inside a longer l*ph body;
    # those offsets are *not* service-order-feasible (Stage-4 drips collide
    # with later segments' Stage-1 chains), so in-order service adds a
    # per-segment convoy penalty. Greedy dispatch absorbs those collisions,
    # so l > 2 keeps opportunistic semantics and the optimized greedy loop.
    if ell <= 2:
        meta["port_inorder"] = True
        meta["vec_exact"] = True
    return Schedule(profile=profile, n=n, nic_flows=flows, meta=meta)


def _optcc_single_legacy(profile: BandwidthProfile, n: int, k: int,
                         fill_bubbles: bool = True,
                         alternate_orderings: bool = True) -> Schedule:
    p = profile.p
    (s_rank,) = profile.stragglers
    ell = profile.slowdown[s_rank]
    if p < 3:
        raise ValueError("OptCC requires p >= 3")
    healthy = [r for r in range(p) if r != s_rank]
    ph = p - 1

    fill = fill_bubbles and ell < 2.0
    if fill:
        # Appendix C: ring path gets fraction l(p-1)/((p-2)l+2) of the data,
        # the star (bubble) path the rest; both split into k bodies.
        ring_frac = ell * ph / ((p - 2) * ell + 2.0)
        ring_n = int(round(n * ring_frac))
    else:
        ring_n = n
    seg_bounds = split_points(ring_n, k)
    star_bounds = split_points(n - ring_n, k) + ring_n  # [ring_n, n)

    # Slotted-timeline constants (ideal, real sizes are integer-rounded).
    s_ideal = ring_n / (k * ph)
    slot_w = max(ell, 2.0) * s_ideal          # straggler slot width
    body = ph * slot_w                        # parallel-body duration

    fl = _FlowList()
    prev_star_up: list[int] = []

    for m in range(k):
        sec_bounds = split_points(int(seg_bounds[m + 1] - seg_bounds[m]), ph) \
            + int(seg_bounds[m])
        ordering_a = (m % 2 == 0) or not alternate_orderings
        t_s1 = m * body                       # S1 rounds: body m
        t_s23 = (m + 1) * body                # S2/S3 slots: body m+1
        t_s4 = (m + 2) * body + (p - 2) * s_ideal   # S4 rounds: body m+2
        for j in range(ph):
            lo, hi = int(sec_bounds[j]), int(sec_bounds[j + 1])
            if hi <= lo:
                continue
            key = ("sec", m, j)
            oidx = (j + m) % ph      # owner rotation = pattern offset
            owner = healthy[oidx]
            if ordering_a:
                # S1: reduce-scatter ending at owner (p-1 nodes, p-2 hops).
                chain = [healthy[(oidx + 1 + t) % ph] for t in range(ph)]
                assert chain[-1] == owner
                s1 = _ring_chain(fl, chain, lo, hi, key,
                                 pri0=t_s1, pri_step=s_ideal)
                # S2: owner uploads healthy partial; straggler folds own.
                s2 = fl.add(owner, s_rank, hi - lo, [s1], lo, hi,
                            Op.ACCUM, key, pri=t_s23 + j * slot_w,
                            stage="S2")
                # S3: straggler downloads global sum to owner.
                s3 = fl.add(s_rank, owner, hi - lo, [s2], lo, hi,
                            Op.STORE, key,
                            pri=t_s23 + j * slot_w + ell * s_ideal,
                            stage="S3")
                # straggler's own output (zero-cost self store).
                fl.add(s_rank, s_rank, 0.0, [s2], lo, hi, Op.STORE, key)
                # S4: allgather among healthy from owner.
                ag = [healthy[(oidx + t) % ph] for t in range(ph)]
                _store_chain(fl, ag, lo, hi, key, first_deps=[s3],
                             pri0=t_s4, pri_step=s_ideal)
            else:
                # S3': straggler uploads raw first; entry node starts ring.
                entry_idx = (j + m) % ph
                chain = [s_rank] + [healthy[(entry_idx + t) % ph]
                                    for t in range(ph)]
                owner = chain[-1]
                # First hop is the straggler's raw upload (S3 in the paper's
                # ordering-B naming); the rest is the healthy ring (S1).
                s1 = _ring_chain(fl, chain, lo, hi, key,
                                 stage=["S3"] + ["S1"] * (len(chain) - 2))
                # owner's own output.
                fl.add(owner, owner, 0.0, [s1], lo, hi, Op.STORE, key)
                # S4: allgather among healthy from owner.
                ag = [healthy[(entry_idx + ph - 1 + t) % ph]
                      for t in range(ph)]
                assert ag[0] == owner
                ag_fids = _store_chain(fl, ag, lo, hi, key, first_deps=[s1])
                # S2': the last allgather receiver returns the global sum.
                fl.add(ag[-1], s_rank, hi - lo, [ag_fids[-1]], lo, hi,
                       Op.STORE, key, stage="S2")

        if fill:
            # Appendix C star all-reduce in the straggler-link bubbles:
            # body m uploads (in the bubble after each S2 recv slot),
            # body m+1 downloads (after each S3 send slot).
            blo, bhi = int(star_bounds[m]), int(star_bounds[m + 1])
            ups: list[int] = []
            if bhi > blo:
                skey = ("star", m)
                for j, h in enumerate(healthy):
                    ups.append(fl.add(
                        h, s_rank, bhi - blo, [], blo, bhi, Op.ACCUM, skey,
                        pri=m * body + j * slot_w + ell * s_ideal,
                        stage="STAR"))
                fl.add(s_rank, s_rank, 0.0, ups, blo, bhi, Op.STORE, skey)
            if prev_star_up:
                pm = m - 1
                plo, phi_ = int(star_bounds[pm]), int(star_bounds[pm + 1])
                for j, h in enumerate(healthy):
                    fl.add(s_rank, h, phi_ - plo, prev_star_up,
                           plo, phi_, Op.STORE, ("star", pm),
                           pri=m * body + j * slot_w + 2 * ell * s_ideal,
                           stage="STAR")
            prev_star_up = ups

    if fill and prev_star_up:
        pm = k - 1
        plo, phi_ = int(star_bounds[pm]), int(star_bounds[pm + 1])
        for j, h in enumerate(healthy):
            fl.add(s_rank, h, phi_ - plo, prev_star_up,
                   plo, phi_, Op.STORE, ("star", pm),
                   pri=(k) * body + j * slot_w + 2 * ell * s_ideal,
                   stage="STAR")

    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    meta={"algo": "optcc-single", "topology": "optcc",
                          "k": k, "ell": ell, "fill": fill,
                          "stage_ids": fl.stage_ids()})


# ----------------------------------------------------------------------------
# m stragglers, one GPU per server (Appendix D)
# ----------------------------------------------------------------------------

def optcc_multi_schedule(profile: BandwidthProfile, n: int, k: int) -> Schedule:
    """Ordering-B-flavoured multi-straggler schedule.

    Stragglers upload their raw sections first; uploads are spread over
    distinct ring nodes (one per straggler) so no single healthy recv port
    concentrates all m uploads. Downloads are likewise spread over distinct
    allgather receivers. Cost structure matches Appendix D.3:
    each straggler i sends/receives (p-m) sections per segment at l_i each.
    """
    p = profile.p
    stragglers = list(profile.stragglers)
    m = len(stragglers)
    healthy = [r for r in range(p) if r not in set(stragglers)]
    ph = p - m
    if ph < 2:
        raise ValueError("need at least 2 healthy GPUs")

    seg_bounds = split_points(n, k)
    fl = _FlowList()

    for seg in range(k):
        sec_bounds = split_points(int(seg_bounds[seg + 1] - seg_bounds[seg]),
                                  ph) + int(seg_bounds[seg])
        for j in range(ph):
            lo, hi = int(sec_bounds[j]), int(sec_bounds[j + 1])
            if hi <= lo:
                continue
            key = ("sec", seg, j)
            oidx = (j + seg) % ph
            # Ring chain covering all healthy, ending at the owner.
            chain = [healthy[(oidx + 1 + t) % ph] for t in range(ph)]
            owner = chain[-1]
            # Straggler i uploads its raw section to the (i+1)-th chain node;
            # that node folds the raw into its buffer before forwarding.
            per_node_deps: dict[int, list[int]] = {}
            ups = []
            for i, srank in enumerate(stragglers):
                tgt = chain[i % ph]
                up = fl.add(srank, tgt, hi - lo, [], lo, hi, Op.ACCUM, key,
                            stage="S3")
                per_node_deps.setdefault(tgt, []).append(up)
                ups.append(up)
            last = _ring_chain(fl, chain, lo, hi, key,
                               per_node_deps=per_node_deps)
            # Owner might hold straggler uploads targeted at itself that the
            # chain didn't wait for; the global sum exists only after both.
            ready = [last] + per_node_deps.get(owner, [])
            # owner's own output.
            fl.add(owner, owner, 0.0, ready, lo, hi, Op.STORE, key)
            # Allgather among healthy from owner.
            ag = [healthy[(oidx + t) % ph] for t in range(ph)]
            assert ag[0] == owner
            ag_fids = _store_chain(fl, ag, lo, hi, key, first_deps=ready)
            # Downloads: the t-th allgather receiver returns the global sum
            # to straggler t (spread across ports).
            for i, srank in enumerate(stragglers):
                node_pos = 1 + (i % (ph - 1))
                sender = ag[node_pos]
                fl.add(sender, srank, hi - lo, [ag_fids[node_pos - 1]],
                       lo, hi, Op.STORE, key, stage="S2")

    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    meta={"algo": "optcc-multi", "topology": "optcc",
                          "k": k, "m": m, "stage_ids": fl.stage_ids()})


# ----------------------------------------------------------------------------
# one straggler server, g GPUs per server (Appendix E)
# ----------------------------------------------------------------------------

def optcc_multi_gpu_schedule(profile: BandwidthProfile, n: int, k: int) -> Schedule:
    """g concurrent lead cycles (one per local GPU index) over q servers,
    each running the single-straggler NIC schedule on its n/g slice, plus
    NVLink collect (N1/N3) before sends and distribute (N2/N4) after
    receives. NVLink ports run at (g-1)x NIC rate (paper's provisioning).
    """
    p, g = profile.p, profile.gpus_per_server
    q = p // g
    if q < 3:
        raise ValueError("need q >= 3 servers")
    # Identify the straggler server.
    sserver = None
    for j in range(q):
        if profile.slowdown[j * g] > 1.0:
            sserver = j
    assert sserver is not None, "no straggler server in profile"
    ell = profile.slowdown[sserver * g]
    healthy_srv = [j for j in range(q) if j != sserver]
    qh = q - 1

    part_bounds = split_points(n, g)
    fl = _FlowList()

    def locals_of(server: int, lead_pos: int) -> list[int]:
        """Server's ranks ordered so the lead is last (collect chain order)."""
        ranks = [server * g + r for r in range(g)]
        lead = server * g + lead_pos
        rest = [r for r in ranks if r != lead]
        return rest + [lead]

    for cyc in range(g):
        c_lo = int(part_bounds[cyc])
        c_n = int(part_bounds[cyc + 1]) - c_lo
        lead = {j: j * g + cyc for j in range(q)}
        s_lead = lead[sserver]
        seg_bounds = split_points(c_n, k) + c_lo
        for seg in range(k):
            sec_bounds = split_points(
                int(seg_bounds[seg + 1] - seg_bounds[seg]), qh) \
                + int(seg_bounds[seg])
            ordering_a = (seg % 2 == 0)
            for j in range(qh):
                lo, hi = int(sec_bounds[j]), int(sec_bounds[j + 1])
                if hi <= lo:
                    continue
                key = ("sec", cyc, seg, j)
                oidx = (j + seg) % qh

                # N1 collect at every healthy server (fold local GPUs into
                # the lead's buffer for this key). Straggler server collect
                # (N3) likewise; all raw-started, order-independent ACCUMs.
                n1_last: dict[int, int] = {}
                for srv in range(q):
                    ch = locals_of(srv, cyc)
                    if g > 1:
                        n1_last[srv] = _ring_chain(
                            fl, ch, lo, hi, key, first_deps=(), nvlink=True,
                            stage="N3" if srv == sserver else "N1")
                per_node_deps = {lead[srv]: [n1_last[srv]]
                                 for srv in n1_last}

                if ordering_a:
                    srv_chain = [healthy_srv[(oidx + 1 + t) % qh]
                                 for t in range(qh)]
                    owner_srv = srv_chain[-1]
                    chain = [lead[srv] for srv in srv_chain]
                    s1 = _ring_chain(fl, chain, lo, hi, key,
                                     per_node_deps=per_node_deps)
                    up_deps = [s1] + per_node_deps.get(chain[-1], [])
                    s2 = fl.add(chain[-1], s_lead, hi - lo, up_deps,
                                lo, hi, Op.ACCUM, key, stage="S2")
                    # straggler lead now needs its *local* collect too before
                    # the download carries the true global sum.
                    down_deps = [s2] + per_node_deps.get(s_lead, [])
                    s3 = fl.add(s_lead, chain[-1], hi - lo, down_deps,
                                lo, hi, Op.STORE, key, stage="S3")
                    fl.add(s_lead, s_lead, 0.0, down_deps, lo, hi,
                           Op.STORE, key)
                    # N2 distribute on the straggler server.
                    if g > 1:
                        _store_chain(fl, locals_of(sserver, cyc)[::-1],
                                     lo, hi, key, first_deps=down_deps,
                                     nvlink=True, stage="N2")
                    ag_srv = [healthy_srv[(oidx + t) % qh] for t in range(qh)]
                    assert ag_srv[0] == owner_srv
                    ag = [lead[srv] for srv in ag_srv]
                    ag_fids = _store_chain(fl, ag, lo, hi, key,
                                           first_deps=[s3])
                    # N4 distribute at every healthy server.
                    if g > 1:
                        _store_chain(fl, locals_of(owner_srv, cyc)[::-1],
                                     lo, hi, key, first_deps=[s3],
                                     nvlink=True, stage="N4")
                        for t in range(1, qh):
                            _store_chain(fl, locals_of(ag_srv[t], cyc)[::-1],
                                         lo, hi, key,
                                         first_deps=[ag_fids[t - 1]],
                                         nvlink=True, stage="N4")
                else:
                    entry_idx = (j + seg) % qh
                    srv_chain = [healthy_srv[(entry_idx + t) % qh]
                                 for t in range(qh)]
                    chain = [s_lead] + [lead[srv] for srv in srv_chain]
                    owner_srv = srv_chain[-1]
                    # Straggler raw upload must carry its full server-local
                    # sum: fold its collect in first.
                    pnd = dict(per_node_deps)
                    pnd.setdefault(s_lead, [])
                    s1 = _ring_chain(fl, chain, lo, hi, key,
                                     per_node_deps=pnd,
                                     stage=["S3"] + ["S1"] * (len(chain) - 2))
                    own_deps = [s1] + per_node_deps.get(chain[-1], [])
                    fl.add(chain[-1], chain[-1], 0.0, own_deps, lo, hi,
                           Op.STORE, key)
                    ag_srv = [healthy_srv[(entry_idx + qh - 1 + t) % qh]
                              for t in range(qh)]
                    assert ag_srv[0] == owner_srv
                    ag = [lead[srv] for srv in ag_srv]
                    ag_fids = _store_chain(fl, ag, lo, hi, key,
                                           first_deps=own_deps)
                    s2p = fl.add(ag[-1], s_lead, hi - lo, [ag_fids[-1]],
                                 lo, hi, Op.STORE, key, stage="S2")
                    if g > 1:
                        # N4 at healthy servers.
                        _store_chain(fl, locals_of(owner_srv, cyc)[::-1],
                                     lo, hi, key, first_deps=own_deps,
                                     nvlink=True, stage="N4")
                        for t in range(1, qh):
                            _store_chain(fl, locals_of(ag_srv[t], cyc)[::-1],
                                         lo, hi, key,
                                         first_deps=[ag_fids[t - 1]],
                                         nvlink=True, stage="N4")
                        # N2 on the straggler server after the final return.
                        _store_chain(fl, locals_of(sserver, cyc)[::-1],
                                     lo, hi, key, first_deps=[s2p],
                                     nvlink=True, stage="N2")

    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    nvlink_flows=fl.nv,
                    meta={"algo": "optcc-multigpu", "topology": "optcc",
                          "k": k, "g": g, "ell": ell,
                          "stage_ids": fl.stage_ids()})


# ----------------------------------------------------------------------------
# dispatcher
# ----------------------------------------------------------------------------

def optcc_schedule(profile: BandwidthProfile, n: int, k: int = 16,
                   fill_bubbles: bool = True) -> Schedule:
    """Build the OptCC schedule appropriate for a bandwidth profile."""
    stragglers = profile.stragglers
    if profile.gpus_per_server > 1:
        if not stragglers:
            return ring_allreduce_schedule(profile, n)
        return optcc_multi_gpu_schedule(profile, n, k)
    if not stragglers:
        return ring_allreduce_schedule(profile, n)
    if len(stragglers) == 1:
        return optcc_single_schedule(profile, n, k, fill_bubbles)
    return optcc_multi_schedule(profile, n, k)
