"""Ring AllReduce flow schedule (Patarasuk-Yuan / NCCL ring).

Used two ways:
  * on a healthy BandwidthProfile -> NCCL_NoFailure baseline (T -> T0);
  * on a degraded profile        -> ICCL baseline: the liveness-oriented
    systems of Section 2 resume the *unchanged* ring after failover, so the
    straggler's slow NIC stays on every chunk's critical path and throttles
    the whole collective (T -> l * T0 in the clean flow model; the paper
    measures even worse under PXN pool congestion, which our single-port
    model does not add on top).

Construction: vector split into p chunks. Reduce-scatter: p-1 rounds, in
round t rank r sends chunk (r - t) mod p to rank (r+1) mod p (ACCUM).
Allgather: p-1 rounds, in round t rank r sends chunk (r + 1 - t) mod p
(STORE). Dependencies follow each chunk's reduction chain, so rounds
pipeline naturally in the simulator.

Each rank additionally sends its rounds *in order* (a FIFO dependency on
its own previous send), modelling a real NCCL ring where a rank's proxy
thread posts sends in ring order. Without this, near-even chunk rounding
lets the greedy simulator reorder sends at mild slowdowns, and the resulting
convoy effect made degraded-ring time non-monotonic in ell.
With FIFO sends the ring is a contention-free max-plus system: every flow
starts exactly at max(finish[deps]), which is (a) provably monotone in every
slowdown factor and (b) what lets `core.flowvec` replay the ring as a
vectorized recurrence, bit-identical to the event loop
(meta["vec_exact"]).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.model import STAGE_ID, BandwidthProfile, Flow, Op, Schedule


def split_points(n: int, parts: int) -> np.ndarray:
    """parts+1 integer boundaries splitting [0, n) near-evenly."""
    return np.round(np.linspace(0, n, parts + 1)).astype(np.int64)


def ring_allreduce_schedule(profile: BandwidthProfile, n: int) -> Schedule:
    p = profile.p
    if p < 2:
        raise ValueError("need p >= 2")
    bounds = split_points(n, p)
    flows: list[Flow] = []
    fid = 0
    # last_flow[(r, c)] = fid of the flow that most recently delivered chunk c
    # to rank r (the dependency for r's next send of chunk c).
    last_recv: dict[tuple[int, int], int] = {}
    # last_send[r] = fid of rank r's previous wire send (FIFO sequencing).
    last_send: dict[int, int] = {}

    def fifo(r: int, deps: tuple[int, ...]) -> tuple[int, ...]:
        prev = last_send.get(r)
        if prev is not None and prev not in deps:
            deps = deps + (prev,)
        return deps

    # Reduce-scatter.
    for t in range(p - 1):
        for r in range(p):
            c = (r - t) % p
            dst = (r + 1) % p
            deps = ()
            if t > 0:
                deps = (last_recv[(r, c)],)
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            flows.append(Flow(fid=fid, src=r, dst=dst, size=hi - lo,
                              deps=fifo(r, deps), lo=lo, hi=hi, op=Op.ACCUM,
                              key=("rs", c)))
            last_recv[(dst, c)] = fid
            last_send[r] = fid
            fid += 1

    # After RS, rank r holds the full sum of chunk (r + 1) mod p. Self-store
    # (zero-cost src==dst flow) so out[] is complete at the owner too.
    for r in range(p):
        c = (r + 1) % p
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        flows.append(Flow(fid=fid, src=r, dst=r, size=0.0,
                          deps=(last_recv[(r, c)],), lo=lo, hi=hi,
                          op=Op.STORE, key=("rs", c)))
        last_recv[(r, c)] = fid
        fid += 1

    # Allgather.
    for t in range(p - 1):
        for r in range(p):
            c = (r + 1 - t) % p
            dst = (r + 1) % p
            deps = (last_recv[(r, c)],)
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            flows.append(Flow(fid=fid, src=r, dst=dst, size=hi - lo,
                              deps=fifo(r, deps), lo=lo, hi=hi, op=Op.STORE,
                              key=("rs", c)))
            last_recv[(dst, c)] = fid
            last_send[r] = fid
            fid += 1

    # Stage tags by fid-block: (p-1)*p RS rounds, p self-stores, (p-1)*p AG.
    stage_ids = np.empty(len(flows), np.int16)
    stage_ids[:(p - 1) * p] = STAGE_ID["RS"]
    stage_ids[(p - 1) * p:p * p] = STAGE_ID["SELF"]
    stage_ids[p * p:] = STAGE_ID["AG"]
    return Schedule(profile=profile, n=n, nic_flows=flows,
                    meta={"algo": "ring", "topology": "ring", "p": p,
                          "vec_exact": True, "stage_ids": stage_ids})
