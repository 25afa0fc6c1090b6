"""Topology-aware AllReduce schedules beyond the single OptCC ring.

Three additional generators for the schedule registry (`core.registry`):

  * hierarchical_schedule - intra-server NVLink reduce + inter-server OptCC
    over one lead rank per server. The inner collective is whatever
    `optcc_schedule` dispatches for the *server-level* profile (each
    server's slowdown is the max over its ranks), so a single slow server
    gets the paper's straggler treatment while the NVLink fan-in/fan-out
    keeps the other g-1 GPUs per box off the NICs entirely.
  * dbtree_schedule - double-binary-tree baseline (NCCL's tree algorithm):
    two balanced trees with disjoint interior roles, each reducing and
    broadcasting one half of the vector. Latency-optimal in depth but moves
    ~2n per interior rank, so it loses to ring/OptCC on bandwidth - it is
    here as the baseline the mesh/tree literature compares against.
  * torus2d_schedule - 2-D torus reduce per *Highly Available Data Parallel
    ML Training on Mesh Networks* (PAPERS.md): row reduce-scatter, column
    reduce-scatter, column allgather, row allgather. Per-rank traffic is
    exactly 2n(p-1)/p (bandwidth-optimal) while every ring is only r or c
    long, which shortens the dependency chains a slow rank sits on.

All three emit flows in topological fid order (the executor's contract) and
tag every flow with a pipeline stage (model.STAGE_NAMES) so telemetry
attribution works unchanged. Each generator has a matching exact per-rank
traffic helper used by its lower bound in `core.lower_bounds`: the bound is
the port-occupancy argument (a rank's NIC send/recv port must carry all its
bytes at >= its own slowdown), computed with the same split arithmetic as
the generator so rounding never pushes the bound above the simulated time.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.model import BandwidthProfile, Op, Schedule
from repro_torch.core.ring import split_points
from repro_torch.core.schedule import _FlowList, optcc_schedule


# ----------------------------------------------------------------------------
# double binary tree (dbtree)
# ----------------------------------------------------------------------------

def _balanced_tree(ranks: tuple[int, ...]) -> tuple[int, dict[int, list[int]]]:
    """Balanced BST over `ranks` (midpoint = root); returns (root, children)."""
    children: dict[int, list[int]] = {}

    def rec(lo: int, hi: int) -> int:
        mid = (lo + hi) // 2
        node = ranks[mid]
        ch = []
        if lo < mid:
            ch.append(rec(lo, mid - 1))
        if mid < hi:
            ch.append(rec(mid + 1, hi))
        children[node] = ch
        return node

    root = rec(0, len(ranks) - 1)
    return root, children


@functools.lru_cache(maxsize=128)
def _dbtree_shape(p: int) -> tuple[tuple[tuple[int, dict]], ...]:
    """The two trees for p ranks: tree 0 over (0..p-1), tree 1 over the
    rotated order (1..p-1, 0) so the interior/leaf roles differ between
    trees (a rank that is interior in one is near-leaf in the other)."""
    t0 = _balanced_tree(tuple(range(p)))
    t1 = _balanced_tree(tuple(range(1, p)) + (0,))
    return ((t0,), (t1,))


def _dbtree_trees(p: int) -> list[tuple[int, dict[int, list[int]]]]:
    return [shape[0] for shape in _dbtree_shape(p)]


@functools.lru_cache(maxsize=128)
def _dbtree_weights(p: int) -> np.ndarray:
    """(2, p) per-rank half-multiples: weights[t, r] halves of tree t's half
    cross rank r's NIC (n-independent, so the planner's closed-form dbtree
    bound/time evaluate as two cached vector scalings, not a Python walk)."""
    w = np.zeros((2, p))
    for t, (root, children) in enumerate(_dbtree_trees(p)):
        for node, ch in children.items():
            w[t, node] = len(ch) + (node != root)
    return w


def dbtree_traffic(p: int, n: int) -> np.ndarray:
    """Exact per-rank NIC traffic (send == recv by symmetry) of the double
    binary tree: per tree t, a non-root sends its half once (reduce) and
    receives it once (broadcast); a node with c children receives c halves
    (reduce) and sends c (broadcast). Segment rounding cancels because the
    k segments of a half sum to the half exactly."""
    halves = np.diff(split_points(n, 2)).astype(np.float64)
    return halves @ _dbtree_weights(p)


def dbtree_schedule(profile: BandwidthProfile, n: int, k: int = 16) -> Schedule:
    """Double-binary-tree AllReduce: reduce to each tree's root, then
    broadcast back down, pipelined over k segments per half. Per-rank FIFO
    send sequencing (like `core.ring`) keeps dispatch deterministic."""
    p = profile.p
    if p < 2:
        raise ValueError("need p >= 2")
    if profile.gpus_per_server != 1:
        raise ValueError("dbtree models one NIC per rank "
                         "(gpus_per_server == 1)")
    trees = _dbtree_trees(p)
    hs = split_points(n, 2)
    fl = _FlowList()
    last_send: dict[int, int] = {}

    def fifo(rank: int, deps: list[int]) -> list[int]:
        prev = last_send.get(rank)
        if prev is not None and prev not in deps:
            deps = deps + [prev]
        return deps

    for t, (root, children) in enumerate(trees):
        lo_t, hi_t = int(hs[t]), int(hs[t + 1])
        seg = np.round(np.linspace(lo_t, hi_t, k + 1)).astype(np.int64)
        # Post-order node list (children before parents).
        order: list[int] = []

        def post(node: int) -> None:
            for ch in children[node]:
                post(ch)
            order.append(node)

        post(root)
        parent = {ch: node for node, chs in children.items() for ch in chs}
        for m in range(k):
            lo, hi = int(seg[m]), int(seg[m + 1])
            key = ("dbt", t, m)
            recv_fids: dict[int, list[int]] = {r: [] for r in order}
            # Reduce: every non-root forwards its subtree sum to its parent
            # once its own children have delivered (post-order emission
            # keeps fids topological).
            for node in order:
                if node == root:
                    continue
                fid = fl.add(node, parent[node], hi - lo,
                             fifo(node, list(recv_fids[node])), lo, hi,
                             Op.ACCUM, key, stage="RS")
                recv_fids[parent[node]].append(fid)
                last_send[node] = fid
            # Root owns the total; zero-cost self-store writes its out[].
            done = fl.add(root, root, 0.0, list(recv_fids[root]), lo, hi,
                          Op.STORE, key, stage="SELF")
            # Broadcast: pre-order from the root.
            done_fid = {root: done}
            stack = [root]
            while stack:
                node = stack.pop()
                for ch in children[node]:
                    fid = fl.add(node, ch, hi - lo,
                                 fifo(node, [done_fid[node]]), lo, hi,
                                 Op.STORE, key, stage="AG")
                    done_fid[ch] = fid
                    last_send[node] = fid
                    stack.append(ch)
    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    meta={"algo": "dbtree", "topology": "dbtree", "p": p,
                          "k": k, "stage_ids": fl.stage_ids()})


# ----------------------------------------------------------------------------
# 2-D torus (torus2d)
# ----------------------------------------------------------------------------

def torus_dims(p: int) -> tuple[int, int] | None:
    """(rows, cols) with rows the largest divisor <= sqrt(p); None when p
    has no 2-D factorization with both sides >= 2 (p prime or p < 4)."""
    r = 1
    d = 2
    while d * d <= p:
        if p % d == 0:
            r = d
        d += 1
    if r < 2:
        return None
    return r, p // r


def _torus_splits(p: int, n: int) -> tuple[np.ndarray, list[np.ndarray]]:
    r, c = torus_dims(p)
    col_pts = split_points(n, c)
    # One broadcast linspace over all c chunks (bit-identical to per-chunk
    # linspace calls, which made this O(c) numpy invocations and pushed the
    # p=1024 closed-form planning path past the 1 ms gate).
    grid = np.round(np.linspace(col_pts[:-1].astype(np.float64),
                                col_pts[1:].astype(np.float64),
                                r + 1, axis=1)).astype(np.int64)
    return col_pts, list(grid)


@functools.lru_cache(maxsize=128)
def _torus2d_phases(p: int, n: int) -> tuple:
    """The four (send, recv) per-rank traffic pairs, cached per (p, n):
    the planner's closed-form path evaluates them twice per plan (own
    lower bound + time model), and the <1 ms schedgen gate covers the
    torus too. Returned arrays are frozen read-only."""
    r, c = torus_dims(p)
    col_pts, sub_pts = _torus_splits(p, n)
    chunk = np.diff(col_pts).astype(np.float64)          # (c,)
    subs = np.diff(np.asarray(sub_pts), axis=1)          # (c, r)
    i = np.arange(r)[:, None]
    j = np.arange(c)[None, :]
    oj = (j + 1) % c                                     # chunk owned after A
    zero = np.zeros((r, c))
    phases = (
        # Row reduce-scatter: send all chunks but (j+1)%c, recv all but j.
        ((n - chunk[(j + 1) % c]) + zero, (n - chunk[j]) + zero),
        # Column reduce-scatter on chunk oj at subchunk granularity.
        (chunk[oj] - subs[oj, (i + 1) % r], chunk[oj] - subs[oj, i]),
        # Column allgather.
        (chunk[oj] - subs[oj, (i + 2) % r],
         chunk[oj] - subs[oj, (i + 1) % r]),
        # Row allgather: send all chunks but (j+2)%c, recv all but (j+1)%c.
        ((n - chunk[(j + 2) % c]) + zero, (n - chunk[(j + 1) % c]) + zero),
    )
    out = tuple((s.reshape(-1), v.reshape(-1)) for s, v in phases)
    for s, v in out:
        s.flags.writeable = False
        v.flags.writeable = False
    return out


@functools.lru_cache(maxsize=128)
def _torus2d_totals(p: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    phases = _torus2d_phases(p, n)
    send = np.sum([s for s, _ in phases], axis=0)
    recv = np.sum([v for _, v in phases], axis=0)
    send.flags.writeable = False
    recv.flags.writeable = False
    return send, recv


def torus2d_traffic(p: int, n: int, per_phase: bool = False):
    """Exact per-rank (send, recv) NIC traffic of the 4-phase torus
    schedule, as flat arrays indexed by rank = i*c + j. Derived from the
    ring identities (a c-ring reduce-scatter sends every chunk except one),
    evaluated on the same integer split points the generator uses. With
    ``per_phase`` returns the list of four (send, recv) pairs instead of
    their sum. Arrays are cached and read-only; copy before mutating."""
    if per_phase:
        return list(_torus2d_phases(p, n))
    return _torus2d_totals(p, n)


def torus2d_schedule(profile: BandwidthProfile, n: int) -> Schedule:
    """2-D torus AllReduce (row RS -> column RS -> column AG -> row AG).

    The vector splits into c column chunks; chunk j splits into r
    subchunks keyed ("t2", j, s). Row-phase wire flows carry a whole chunk
    (main part + r-1 `extra` parts, one per subchunk) so buffers stay
    keyed at subchunk granularity for the column phases. After row RS,
    rank (i, j) owns the row-sum of chunk (j+1)%c; after column RS it owns
    the global sum of subchunk ((j+1)%c, (i+1)%r); the allgathers reverse
    both scatters. Per-rank FIFO send sequencing throughout."""
    p = profile.p
    dims = torus_dims(p)
    if dims is None:
        raise ValueError(f"p={p} has no 2-D torus factorization "
                         f"(needs a divisor pair >= 2x2)")
    if profile.gpus_per_server != 1:
        raise ValueError("torus2d models one NIC per rank "
                         "(gpus_per_server == 1)")
    r, c = dims
    col_pts, sub_pts = _torus_splits(p, n)

    def rank(i: int, j: int) -> int:
        return i * c + j

    fl = _FlowList()
    last_send: dict[int, int] = {}

    def fifo(rk: int, deps: list[int]) -> list[int]:
        prev = last_send.get(rk)
        if prev is not None and prev not in deps:
            deps = deps + [prev]
        return deps

    def chunk_parts(cj: int, op: Op) -> list[tuple[int, int, Op, tuple]]:
        return [(int(sub_pts[cj][s]), int(sub_pts[cj][s + 1]), op,
                 ("t2", cj, s)) for s in range(r)]

    # Phase A: row reduce-scatter (chunk granularity, subchunk parts).
    recv_a: dict[tuple[int, int], int] = {}   # (rank, chunk) -> arrival fid
    for t in range(c - 1):
        for i in range(r):
            for j in range(c):
                cj = (j - t) % c
                src, dst = rank(i, j), rank(i, (j + 1) % c)
                deps = [] if t == 0 else [recv_a[(src, cj)]]
                parts = chunk_parts(cj, Op.ACCUM)
                lo0, hi0, op0, key0 = parts[0]
                fid = fl.add(src, dst, int(col_pts[cj + 1] - col_pts[cj]),
                             fifo(src, deps), lo0, hi0, op0, key0,
                             extra=parts[1:], stage="RS")
                recv_a[(dst, cj)] = fid
                last_send[src] = fid

    # Phase B: column reduce-scatter of the owned chunk (j+1)%c.
    recv_b: dict[tuple[int, int], int] = {}   # (rank, subchunk) -> fid
    for t in range(r - 1):
        for j in range(c):
            oj = (j + 1) % c
            for i in range(r):
                s = (i - t) % r
                src, dst = rank(i, j), rank((i + 1) % r, j)
                deps = [recv_a[(src, oj)]] if t == 0 else [recv_b[(src, s)]]
                lo, hi = int(sub_pts[oj][s]), int(sub_pts[oj][s + 1])
                fid = fl.add(src, dst, hi - lo, fifo(src, deps), lo, hi,
                             Op.ACCUM, ("t2", oj, s), stage="RS")
                recv_b[(dst, s)] = fid
                last_send[src] = fid

    # Self-stores: rank (i, j) owns subchunk ((j+1)%c, (i+1)%r) globally.
    self_fid: dict[int, int] = {}
    for i in range(r):
        for j in range(c):
            oj, oi = (j + 1) % c, (i + 1) % r
            rk = rank(i, j)
            lo, hi = int(sub_pts[oj][oi]), int(sub_pts[oj][oi + 1])
            self_fid[rk] = fl.add(rk, rk, 0.0, [recv_b[(rk, oi)]], lo, hi,
                                  Op.STORE, ("t2", oj, oi), stage="SELF")

    # Phase C: column allgather of the owned chunk's subchunks.
    recv_c: dict[tuple[int, int], int] = {}
    last_c: dict[int, int] = {}
    for t in range(r - 1):
        for j in range(c):
            oj = (j + 1) % c
            for i in range(r):
                s = (i + 1 - t) % r
                src, dst = rank(i, j), rank((i + 1) % r, j)
                deps = [self_fid[src]] if t == 0 else [recv_c[(src, s)]]
                lo, hi = int(sub_pts[oj][s]), int(sub_pts[oj][s + 1])
                fid = fl.add(src, dst, hi - lo, fifo(src, deps), lo, hi,
                             Op.STORE, ("t2", oj, s), stage="AG")
                recv_c[(dst, s)] = fid
                last_c[dst] = fid
                last_send[src] = fid

    # Phase D: row allgather (chunk granularity, subchunk parts).
    recv_d: dict[tuple[int, int], int] = {}
    for t in range(c - 1):
        for i in range(r):
            for j in range(c):
                cj = (j + 1 - t) % c
                src, dst = rank(i, j), rank(i, (j + 1) % c)
                if t == 0:
                    # The full owned chunk is ready once the self-store and
                    # the last column-AG arrival (FIFO-ordered) are done.
                    deps = [self_fid[src]]
                    if src in last_c:
                        deps.append(last_c[src])
                else:
                    deps = [recv_d[(src, cj)]]
                parts = chunk_parts(cj, Op.STORE)
                lo0, hi0, op0, key0 = parts[0]
                fid = fl.add(src, dst, int(col_pts[cj + 1] - col_pts[cj]),
                             fifo(src, deps), lo0, hi0, op0, key0,
                             extra=parts[1:], stage="AG")
                recv_d[(dst, cj)] = fid
                last_send[src] = fid

    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    meta={"algo": "torus2d", "topology": "torus2d", "p": p,
                          "rows": r, "cols": c, "stage_ids": fl.stage_ids()})


# ----------------------------------------------------------------------------
# hierarchical (NVLink reduce per server + OptCC across servers)
# ----------------------------------------------------------------------------

def server_slowdowns(profile: BandwidthProfile) -> tuple[float, ...]:
    """Per-server effective NIC slowdown: the max over the server's ranks
    (PXN pools every GPU on the box through the shared NICs)."""
    g = profile.gpus_per_server
    return tuple(max(profile.slowdown[s * g:(s + 1) * g])
                 for s in range(profile.num_servers))


def hierarchical_inner_profile(profile: BandwidthProfile) -> BandwidthProfile:
    """The server-level (one rank per server) profile the inter-server
    collective runs on."""
    return BandwidthProfile(p=profile.num_servers,
                            slowdown=server_slowdowns(profile),
                            gpus_per_server=1)


def hierarchical_schedule(profile: BandwidthProfile, n: int, k: int = 16,
                          fill_bubbles: bool = True) -> Schedule:
    """Intra-server NVLink reduce + inter-server OptCC over one lead/server.

    Per server, a NVLink ACCUM chain folds the g-1 non-lead GPUs into the
    lead's buffer for every inter-server transfer key; the inner schedule
    (`optcc_schedule` on the server-level profile, so ring when healthy and
    the straggler-aware OptCC otherwise) then runs unchanged between the
    leads, sending server sums instead of single-rank vectors; finally each
    inner STORE fans back out over NVLink to the server's other GPUs.
    Appendix-C bubble filling is disabled for the inner schedule: the fill
    fraction is calibrated for single-rank uploads, not server sums.

    ``fill_bubbles`` is accepted for planner-API uniformity and ignored.
    """
    del fill_bubbles
    g = profile.gpus_per_server
    if g < 2:
        raise ValueError("hierarchical needs gpus_per_server >= 2")
    q = profile.num_servers
    inner = optcc_schedule(hierarchical_inner_profile(profile), n, k,
                           fill_bubbles=False)
    inner_flows = sorted(inner.nic_flows, key=lambda f: f.fid)
    inner_stages = inner.meta.get("stage_ids")
    from repro_torch.core.model import STAGE_NAMES

    def lead(s: int) -> int:
        return s * g

    def locals_of(s: int) -> list[int]:
        return list(range(s * g + 1, (s + 1) * g))

    # Distinct transfer keys (1:1 with [lo, hi) ranges), in first-use order.
    key_range: dict[tuple, tuple[int, int]] = {}
    for f in inner_flows:
        for lo, hi, _op, key in ((f.lo, f.hi, f.op, f.key), *f.extra):
            key_range.setdefault(key, (int(lo), int(hi)))

    fl = _FlowList()
    nv_last_send: dict[int, int] = {}

    def nv_fifo(rk: int, deps: list[int]) -> list[int]:
        prev = nv_last_send.get(rk)
        if prev is not None and prev not in deps:
            deps = deps + [prev]
        return deps

    # Phase 1: per-(server, key) NVLink collect chains into the lead.
    coll: list[dict[tuple, int]] = [dict() for _ in range(q)]
    for key, (lo, hi) in key_range.items():
        for s in range(q):
            nodes = locals_of(s) + [lead(s)]
            last = None
            for a, b in zip(nodes[:-1], nodes[1:]):
                deps = [] if last is None else [last]
                last = fl.add(a, b, hi - lo, nv_fifo(a, deps), lo, hi,
                              Op.ACCUM, key, nvlink=True, stage="N1")
                nv_last_send[a] = last
            coll[s][key] = last

    # Phase 2: the inner schedule, remapped onto the leads. Each flow
    # additionally depends on both endpoints' collects for its keys, so a
    # lead always forwards the *server* sum, never its raw vector.
    fmap: dict[int, int] = {}
    arrived: dict[tuple[int, tuple], int] = {}
    for f in inner_flows:
        deps = [fmap[d] for d in f.deps]
        for _lo, _hi, _op, key in ((f.lo, f.hi, f.op, f.key), *f.extra):
            for s in {f.src, f.dst}:
                cfid = coll[s][key]
                if cfid not in deps:
                    deps.append(cfid)
        stage = (STAGE_NAMES[int(inner_stages[f.fid])]
                 if inner_stages is not None else "SELF")
        nf = fl.add(lead(f.src), lead(f.dst), f.size, deps, f.lo, f.hi,
                    f.op, f.key, pri=f.pri, extra=f.extra, stage=stage)
        fmap[f.fid] = nf
        for lo, hi, op, key in ((f.lo, f.hi, f.op, f.key), *f.extra):
            if op is Op.STORE:
                arrived[(f.dst, key)] = nf

    missing = [(s, key) for s in range(q) for key in key_range
               if (s, key) not in arrived]
    assert not missing, f"inner schedule never stores {missing[:3]} ..."

    # Phase 3: NVLink distribute chains fan every stored key back out to
    # the server's non-lead GPUs.
    for (s, key), store_fid in arrived.items():
        lo, hi = key_range[key]
        nodes = [lead(s)] + locals_of(s)[::-1]
        prev = store_fid
        for a, b in zip(nodes[:-1], nodes[1:]):
            prev = fl.add(a, b, hi - lo, nv_fifo(a, [prev]), lo, hi,
                          Op.STORE, key, nvlink=True, stage="N2")
            nv_last_send[a] = prev

    return Schedule(profile=profile, n=n, nic_flows=fl.nic,
                    nvlink_flows=fl.nv,
                    meta={"algo": "hierarchical", "topology": "hierarchical",
                          "p": profile.p, "k": k, "g": g, "q": q,
                          "inner_algo": inner.meta.get("algo"),
                          "stage_ids": fl.stage_ids()})
