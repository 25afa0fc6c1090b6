"""Data-level execution of a flow schedule: verifies AllReduce correctness.

The executor runs the *same* Schedule object the simulator times, but instead
of tracking time it moves real payloads - torch tensors, on the device of the
input (the CPU in the tests, the card in chip_smoke.py's `schedules` phase).
A schedule is correct iff after executing all flows in any
dependency-respecting order, every rank's output vector equals sum_i x_i
(Section 3's correctness definition).

Flow semantics (see core.model.Op):
  sender payload = bufs[src][key] if present else x[src][lo:hi]
  ACCUM at dst:   bufs[dst][key] = (bufs[dst][key] or x[dst][lo:hi]) + payload
  STORE at dst:   out[dst][lo:hi] = payload; bufs[dst][key] = payload

Because ACCUM initializes once with the receiver's own contribution and then
order-independently accumulates, the executor result is invariant to the
interleaving the simulator happens to choose - we execute in topological
(fid) order for determinism.

A STORE leaves the sender's tensor itself in the receiver's buffer, so one
tensor may be reachable from several ranks: ACCUM therefore adds out of
place, as the JAX package's numpy executor does, and never writes into a
buffer or into x. The adds stay in the payload's dtype (a bf16 add is an
fp32 sum rounded once to bf16, as numpy's bfloat16 add is), so the result
equals the JAX executor's to the bit. They are plain torch ops and not the
chunk_reduce kernel: that kernel adds whole rows of one (R, C) buffer, while
a schedule's flows are ranges of unequal length held in separate tensors.

As in the JAX package, x's length is not checked against `schedule.n`: a
range past the end of x is clipped, so a schedule must be executed at its
own n to prove anything.
"""
from __future__ import annotations

import torch

from repro_torch.core.model import Op, Schedule


def execute(schedule: Schedule, x: torch.Tensor) -> torch.Tensor:
    """Execute `schedule` on inputs x of shape (p, n); returns out (p, n) on
    x's device, NaN where no flow stored a result.

    Raises if a flow runs before one of its dependencies; the caller
    asserts out == x.sum(0) per rank.
    """
    p, n = x.shape
    if p != schedule.profile.p:
        raise ValueError(f"x has {p} ranks, profile has {schedule.profile.p}")
    out = torch.full((p, n), float("nan"), dtype=x.dtype, device=x.device)
    bufs: list[dict] = [dict() for _ in range(p)]
    # per-rank row views: slicing a 1-D view costs the host half what
    # indexing the (p, n) tensor does, and flows are many and short
    xs, outs = x.unbind(0), out.unbind(0)

    flows = sorted(schedule.nic_flows + schedule.nvlink_flows,
                   key=lambda f: f.fid)
    done: set[int] = set()

    def apply_part(src: int, dst: int, lo: int, hi: int, op: Op, key: tuple):
        if hi <= lo:
            return
        payload = bufs[src].get(key)
        if payload is None:
            payload = xs[src][lo:hi]         # a view: nothing writes into x
        if op is Op.ACCUM:
            base = bufs[dst].get(key)
            if base is None:
                base = xs[dst][lo:hi]
            bufs[dst][key] = base + payload  # out of place: see the docstring
        elif op is Op.STORE:
            outs[dst][lo:hi] = payload
            bufs[dst][key] = payload
        else:
            raise ValueError(f"unknown op {op}")

    for f in flows:
        for d in f.deps:
            if d not in done:
                raise ValueError(
                    f"flow {f.fid} executed before dependency {d}; "
                    "generator must emit flows in topological fid order")
        apply_part(f.src, f.dst, int(f.lo), int(f.hi), f.op, f.key)
        for (lo, hi, op, key) in f.extra:
            apply_part(f.src, f.dst, int(lo), int(hi), op, key)
        done.add(f.fid)
    return out


def verify_allreduce(schedule: Schedule, x: torch.Tensor,
                     rtol: float = 1e-6, atol: float = 1e-6) -> None:
    """Assert every rank ends with the element-wise sum of all inputs:
    |out[r] - x.sum(0)| <= atol + rtol |x.sum(0)| everywhere (NaN fails),
    compared in float64."""
    out = execute(schedule, x)
    expected = x.sum(dim=0).double()
    limit = atol + rtol * expected.abs()
    for r in range(x.shape[0]):
        err = (out[r].double() - expected).abs()
        bad = ~(err <= limit)
        if bool(bad.any()):
            raise AssertionError(
                f"rank {r} does not hold the global sum: {int(bad.sum())} "
                f"of {bad.numel()} elements off, first at "
                f"{int(bad.nonzero()[0])}, largest error "
                f"{float(err.nan_to_num(float('inf')).max())}")
