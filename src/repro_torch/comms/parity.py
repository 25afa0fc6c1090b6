"""Every collective of `comms/collectives.py` on one set of seeded inputs,
on whichever transport it is given, for checks that the transports agree.

`run_suite(tr, arrays, ...)` runs psum (fp32 and bf16), the ring, OptCC
flat and as a tree (stragglers 0, 1 and 3 where p allows), the mixed-dtype
psum_tree, hierarchical_psum and compressed_psum (with and without error
feedback) over the members `tr` holds, and returns per collective the
results of those members, the link counts it added, its wall seconds, its
chunk_reduce launches and, on a `ProcessTransport`, its hops. Called with a
`LocalTransport` in one process and with a `ProcessTransport` in each rank
(`rank_suite`, through `comms.dist.spawn`), it gives what the two must
agree on to the bit.

`full_length(rank, ...)` is the card's check at a training gradient's
length: psum in bf16 and the OptCC tree in fp32 on inputs made on the
device from per-(rank, segment) seeds, each result held on every rank
against the sum recomputed from those seeds segment by segment.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.comms.collectives import (compressed_psum, hierarchical_psum,
                                           optcc_allreduce,
                                           optcc_allreduce_tree, psum,
                                           psum_tree, ring_allreduce)
from repro_torch.comms.dist import rank_device
from repro_torch.comms.transport import ProcessTransport
from repro_torch.kernels import launch_counts
from repro_torch.kernels.chunk_reduce import chunk_reduce, chunk_reduce_pairs_

STRAGGLERS = (0, 1, 3)
# a p-term fp32 sum in another association differs by at most
# 2 (p-1) 2^-24 sum|x_i|; the limit is 1e-6 (1 + sum|x_i|)
SUM_TOL = 1e-6


def inputs(p: int, n: int, seed: int = 0) -> dict:
    """(p, n) fp32 arrays: normal `x`, an error-feedback term `error` (1e-2
    scale) and `dyadic` multiples of 1/8 (sums exact in any order)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((p, n)).astype(np.float32),
            "error": (1e-2 * rng.standard_normal((p, n))).astype(np.float32),
            "dyadic": (rng.integers(-128, 128, (p, n)) / 8
                       ).astype(np.float32)}


def hierarchies(p: int) -> tuple:
    """The inner group sizes hierarchical_psum runs at for p members."""
    return tuple(i for i in (2, 1, p) if p % i == 0 and i <= p)[:2]


def bit_digest(t: torch.Tensor) -> tuple:
    """(dtype, shape, two integer sums over t's bits as 16-bit words, one
    weighted by position mod 251): equal for bit-equal tensors, computed on
    t's device in slices of 2^26 words."""
    flat = t.detach().contiguous().reshape(-1)
    words = flat.view(torch.uint8)
    words = words.view(torch.int16) if words.numel() % 2 == 0 else \
        words.to(torch.int16)
    plain = weighted = 0
    step = 1 << 26
    for start in range(0, words.numel(), step):
        w = words[start:start + step].long()
        pos = torch.arange(start, start + w.numel(), device=w.device)
        plain += int(w.sum())
        weighted += int((w * (pos % 251 + 1)).sum())
    return str(t.dtype), tuple(t.shape), plain, weighted


def _kept(res, digest: bool):
    if isinstance(res, torch.Tensor):
        return bit_digest(res) if digest else res.detach().cpu()
    return type(res)(_kept(r, digest) for r in res)


def _row(res, r: int):
    """Member row r of a per-member result (a tensor or a tuple of them)."""
    if isinstance(res, torch.Tensor):
        return res[r]
    return type(res)(_row(t, r) for t in res)


# the collectives whose result every member holds alike (the others return
# a row per member)
SHARED = ("psum", "tree")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_suite(tr, arrays: dict, device="cpu", digest: bool = False) -> dict:
    """Every collective on the rows of `arrays` (see `inputs`) of the
    members tr holds: {name: {"out", "elems", "bytes", "seconds",
    "launches"[, "hops"]}}. "out" has one entry per member held, its
    result (CPU tensors, or `bit_digest`s with `digest`); "elems" /
    "bytes" the link counts the collective added (a process counts its own
    sends and receives)."""
    device = torch.device(device)
    p, n = tr.p, arrays["x"].shape[1]
    rows = list(tr.members)

    def held(name, dtype=torch.float32):
        return torch.from_numpy(arrays[name][rows]).to(device, dtype)

    x, error, dyadic = held("x"), held("error"), held("dyadic")
    h = n // 2

    def tree_members():
        for r in range(len(rows)):
            yield [x[r, :h], x[r, h:n - 4].reshape(-1, 1),
                   x[r, n - 4:].to(torch.bfloat16)]

    def mixed_members():
        for r in range(len(rows)):
            yield [x[r, :h].to(torch.bfloat16), x[r, h:]]

    cases = {"psum_fp32": lambda: psum(x, tr),
             "psum_bf16": lambda: psum(x.to(torch.bfloat16), tr),
             "ring": lambda: ring_allreduce(x[:, :n - n % p], tr),
             "psum_tree": lambda: psum_tree(mixed_members(), tr)}
    for s in STRAGGLERS:
        if s < p and p >= 3:
            cases[f"optcc_{s}"] = lambda s=s: optcc_allreduce(x, s, tr)
            cases[f"tree_{s}"] = lambda s=s: optcc_allreduce_tree(
                tree_members(), s, tr)
    for inner in hierarchies(p):
        for outer in (True, False):
            cases[f"hier_{inner}_{outer}"] = \
                lambda i=inner, o=outer: hierarchical_psum(x, i, tr, o)
    cases["compressed"] = lambda: compressed_psum(x, tr, error)
    cases["compressed_dyadic"] = lambda: compressed_psum(dyadic, tr)
    out = {}
    for name, fn in cases.items():
        tr.reset_counts()
        before = launch_counts()
        _sync(device)
        t = time.perf_counter()
        res = fn()
        _sync(device)
        seconds = time.perf_counter() - t
        after = launch_counts()
        if name.startswith(SHARED):
            kept = [_kept(res, digest)] * len(rows)
        else:
            kept = [_kept(_row(res, r), digest) for r in range(len(rows))]
        out[name] = {"out": kept,
                     "elems": tr.link_elems.copy(),
                     "bytes": tr.link_bytes.copy(), "seconds": seconds,
                     "launches": {k: after[k] - before[k] for k in
                                  ("chunk_reduce", "chunk_reduce_pairs")}}
        if isinstance(tr, ProcessTransport):
            out[name]["hops"] = tr.hop_stats()
    return out


def _warm(device: torch.device) -> None:
    """On a card, launch both chunk_reduce forms once before anything is
    timed: the first launch loads the library and its module, which the
    CUDA events around a combine would otherwise count."""
    if device.type == "cuda":
        rows = torch.zeros((2, 16), device=device)
        chunk_reduce(rows)
        chunk_reduce_pairs_(rows, [0], [1])
        torch.cuda.synchronize(device)


def rank_suite(rank: int, p: int, n: int, seed: int, device: str,
               segment_bytes: int, digest: bool) -> dict:
    """`run_suite` on this rank's ProcessTransport (a `spawn` target)."""
    device = rank_device(device)
    _warm(device)
    tr = ProcessTransport(segment_bytes)
    return run_suite(tr, inputs(p, n, seed), device, digest)


# ----------------------------------------------------------------------------
# the card's full-length check
# ----------------------------------------------------------------------------

def _segment(member: int, k: int, length: int, seed: int,
             device: torch.device) -> torch.Tensor:
    """Member `member`'s input elements [k S, k S + length): normal fp32
    from the seed of (seed, member, k)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + member * 65_537 + k)
    return torch.randn(length, generator=gen, device=device)


def _member_input(member: int, n: int, seg: int, seed: int, device,
                  dtype) -> torch.Tensor:
    out = torch.empty(n, dtype=dtype, device=device)
    for k, start in enumerate(range(0, n, seg)):
        length = min(seg, n - start)
        out[start:start + length] = _segment(member, k, length, seed, device)
    return out


def _held_to_sum(got: torch.Tensor, p: int, n: int, seg: int, seed: int,
                 device, dtype, exact: bool) -> float:
    """Max |got - sum of the p inputs|, recomputed segment by segment; the
    sum is fp32 in member order, rounded once to `dtype`. Raises unless
    bit-equal (`exact`) or within SUM_TOL (1 + sum|x_i|)."""
    err = 0.0
    for k, start in enumerate(range(0, n, seg)):
        length = min(seg, n - start)
        acc = torch.zeros(length, dtype=torch.float32, device=device)
        mag = torch.zeros_like(acc)
        for j in range(p):
            part = _segment(j, k, length, seed, device).to(dtype)
            acc += part.float()
            mag += part.float().abs()
        want = acc.to(dtype).float()
        g = got[start:start + length].float()
        diff = (g - want).abs()
        err = max(err, float(diff.max()))
        if exact:
            if not torch.equal(g, want):
                raise AssertionError(f"segment {k}: not bit-equal to the sum "
                                     f"(max abs err {err})")
        elif bool((diff > SUM_TOL * (1.0 + mag)).any()):
            raise AssertionError(f"segment {k}: off the sum by up to {err}")
    return err


def full_length(rank: int, p: int, n: int, seed: int, device: str,
                segment_bytes: int, straggler: int = 1,
                check_segment: int = 1 << 26) -> dict:
    """psum (bf16) and optcc_allreduce_tree (fp32, one leaf, `straggler`)
    of n elements on this rank's ProcessTransport (a `spawn` target). Each
    result is held against the sum recomputed from the seeds: psum to the
    bit (one W-way fp32 sum in member order, one rounding), the tree within
    SUM_TOL. Returns per collective its wall seconds, hops, link counts,
    launches and error, and the rank's peak device memory."""
    device = rank_device(device)
    _warm(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tr = ProcessTransport(segment_bytes)
    out = {}
    for name, dtype in (("psum", torch.bfloat16), ("tree", torch.float32)):
        tr.reset_counts()
        before = launch_counts()
        if name == "psum":
            x = _member_input(rank, n, check_segment, seed, device, dtype)
            _sync(device)
            t = time.perf_counter()
            got = psum(x[None], tr)
        else:
            members = ([_member_input(rank, n, check_segment, seed, device,
                                      dtype)] for _ in range(1))
            _sync(device)
            t = time.perf_counter()
            got = optcc_allreduce_tree(members, straggler, tr)[0]
        _sync(device)
        seconds = time.perf_counter() - t
        after = launch_counts()
        x = None
        err = _held_to_sum(got, p, n, check_segment, seed, device, dtype,
                           exact=name == "psum")
        del got
        out[name] = {"seconds": seconds, "max_abs_err": err,
                     "elems": tr.link_elems.copy(),
                     "bytes": tr.link_bytes.copy(), "hops": tr.hop_stats(),
                     "launches": {k: after[k] - before[k] for k in
                                  ("chunk_reduce", "chunk_reduce_pairs")}}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return out
