"""Software collectives: the paper's schedules over the DP members of a
`LocalTransport` (the port of `repro/comms/collectives.py`).

A DP-sharded value is a tensor whose leading dimension is the member: x
(p, n) holds member i's vector in row i, and a collective returns (p, ...)
with member i's result in row i. Every combine is the chunk_reduce kernel:
psum is its W-way form over the p member rows; each reduce-scatter hop and
the straggler fold is one launch of its in-place pair form.

  * psum - lax.psum: the (n,) sum every member holds;
  * ring_reduce_scatter / ring_all_gather / ring_allreduce - the NCCL ring
    baseline (Patarasuk-Yuan): at step t member i sends chunk (i - t).
  * optcc_allreduce - OptCC's stage structure for one degraded member: the
    straggler's vector enters the healthy subring once, the p-1 healthy
    members reduce-scatter + allgather among themselves, and one flow
    returns the result to the straggler. The straggler's link carries 2n
    elements total - the information-theoretic minimum (Lemma 5) - instead
    of the 2n(p-1)/p it would carry inside a symmetric ring.

Padding, ring positions and chunk ownership follow the JAX functions, and
so does every addition's operand pair, so in fp32 the results agree with
them bit for bit.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from repro_torch.comms.transport import LocalTransport
from repro_torch.kernels.chunk_reduce import chunk_reduce


def psum(x: torch.Tensor) -> torch.Tensor:
    """x: (p, n) -> (n,), the sum every member holds (lax.psum), in x's
    dtype with fp32 accumulation."""
    return chunk_reduce(x, out_dtype=x.dtype)


def _reduce_scatter_(tr: LocalTransport, acc: torch.Tensor,
                     ring: Sequence[int]) -> None:
    """In place on acc (p, m, c) over the members of `ring` (m of them, in
    ring order): afterwards ring[i] holds the full sum of chunk (i+1) % m."""
    m = len(ring)
    for t in range(m - 1):
        tr.accumulate(acc, [(ring[i], (i - t) % m, ring[(i + 1) % m],
                             (i - t) % m) for i in range(m)])


def _all_gather_(tr: LocalTransport, acc: torch.Tensor,
                 ring: Sequence[int]) -> None:
    """In place: ring[i] starts with chunk (i+1) % m final and ends with
    every chunk, each received from its predecessor."""
    m = len(ring)
    for t in range(m - 1):
        tr.copy(acc, [(ring[i], (i + 1 - t) % m, ring[(i + 1) % m],
                       (i + 1 - t) % m) for i in range(m)])


def ring_reduce_scatter(x: torch.Tensor, tr: LocalTransport) -> torch.Tensor:
    """x: (p, n), n % p == 0 -> (p, n/p): member i holds chunk (i+1) mod p
    of sum_j x_j."""
    p, n = x.shape
    if n % p:
        raise ValueError("pad the vector to a multiple of the axis size")
    acc = x.reshape(p, p, n // p).clone()
    _reduce_scatter_(tr, acc, range(p))
    members = torch.arange(p)
    return acc[members, (members + 1) % p]


def ring_all_gather(chunks: torch.Tensor, tr: LocalTransport) -> torch.Tensor:
    """Inverse of ring_reduce_scatter: (p, c) -> (p, p c), member i
    contributes chunk (i+1)."""
    p, c = chunks.shape
    out = torch.zeros((p, p, c), dtype=chunks.dtype, device=chunks.device)
    members = torch.arange(p)
    out[members, (members + 1) % p] = chunks
    _all_gather_(tr, out, range(p))
    return out.reshape(p, p * c)


def ring_allreduce(x: torch.Tensor, tr: LocalTransport) -> torch.Tensor:
    """Reference ring AllReduce (== psum) built from the two halves."""
    return ring_all_gather(ring_reduce_scatter(x, tr), tr)


def optcc_allreduce_(buf: torch.Tensor, straggler: int,
                     tr: LocalTransport) -> torch.Tensor:
    """OptCC AllReduce in place on buf (p, npad), npad % (p-1) == 0 (the
    caller padded with zeros); every row ends holding the sum."""
    p, npad = buf.shape
    if p < 3:
        raise ValueError("optcc_allreduce needs axis size >= 3")
    if not 0 <= straggler < p:
        raise ValueError(f"straggler {straggler} outside 0..{p - 1}")
    ph = p - 1
    if npad % ph:
        raise ValueError(f"buffer length {npad} is not a multiple of {ph}")
    healthy = [r for r in range(p) if r != straggler]
    peer = healthy[0]
    acc = buf.view(p, ph, npad // ph)
    # Stage "S3'" (ordering B): straggler -> peer; peer folds it in.
    tr.accumulate(acc, [(straggler, j, peer, j) for j in range(ph)])
    # Stages S1/S4 on the healthy subring; healthy[i] plays position i.
    _reduce_scatter_(tr, acc, healthy)
    _all_gather_(tr, acc, healthy)
    # Stage "S2'": one healthy member returns the sum to the straggler.
    tr.copy(acc, [(peer, j, straggler, j) for j in range(ph)])
    return buf


def optcc_allreduce(x: torch.Tensor, straggler: int,
                    tr: LocalTransport) -> torch.Tensor:
    """x: (p, n) -> (p, n), every row the sum, where member `straggler` has
    a degraded link: its link carries the vector out once and the sum back
    once (2 npad elements), all other traffic runs on the healthy ring."""
    p, n = x.shape
    buf = torch.zeros((p, n + (-n) % max(p - 1, 1)), dtype=x.dtype,
                      device=x.device)
    buf[:, :n] = x
    return optcc_allreduce_(buf, straggler, tr)[:, :n]


def _pack(members: Iterable[Sequence[torch.Tensor]], p: int,
          dtype: Optional[torch.dtype], multiple: int):
    """Flatten-concat member i's leaves into row i of (p, npad) buffers,
    consuming the members one at a time (only one member's leaves need be
    alive at once): one buffer of `dtype` for every leaf, or with `dtype`
    None one buffer per leaf dtype, each holding the leaves of its dtype
    in their order; the tail of a buffer past its leaves, up to a
    multiple of `multiple`, is zero. Returns ({buffer dtype: buffer},
    layout: (buffer dtype, offset, shape, dtype) per leaf)."""
    bufs, layout = None, None
    count = 0
    for i, leaves in enumerate(members):
        if i >= p:
            raise ValueError(f"more than p={p} members")
        if bufs is None:
            layout, sizes = [], {}
            for leaf in leaves:
                group = dtype or leaf.dtype
                off = sizes.get(group, 0)
                layout.append((group, off, leaf.shape, leaf.dtype))
                sizes[group] = off + leaf.numel()
            bufs = {}
            for group, n in sizes.items():
                bufs[group] = torch.empty((p, n + (-n) % multiple),
                                          dtype=group,
                                          device=leaves[0].device)
                bufs[group][:, n:].zero_()
        for (group, off, shape, _), leaf in zip(layout, leaves):
            bufs[group][i, off:off + leaf.numel()].copy_(leaf.reshape(-1))
        count += 1
    if count != p:
        raise ValueError(f"expected {p} members, got {count}")
    return bufs, layout


def _unpack(flats: dict, layout) -> list[torch.Tensor]:
    """The leaves of `layout` out of the summed (n,) buffer of each
    group, each cast back to its dtype."""
    return [flats[group][off:off + shape.numel()].view(shape).to(dtype)
            for group, off, shape, dtype in layout]


def psum_tree(members: Iterable[Sequence[torch.Tensor]],
              tr: LocalTransport) -> list[torch.Tensor]:
    """lax.psum over a list of leaves per member, each leaf summed in its
    own dtype as JAX psums it: flatten-concat the leaves of each dtype into
    one buffer, one W-way chunk_reduce per buffer, split. (One buffer in
    the leaves' common dtype would be the same sum, bit for bit - the
    kernel adds exact inputs in fp32 and rounds once - but hymba's bf16
    gradients beside its fp32 leaves would then take twice the memory.)
    `members` yields p leaf lists of equal shapes; returns the summed
    leaves every member holds."""
    bufs, layout = _pack(members, tr.p, None, 1)
    return _unpack({g: psum(buf) for g, buf in bufs.items()}, layout)


def optcc_allreduce_tree(members: Iterable[Sequence[torch.Tensor]],
                         straggler: int,
                         tr: LocalTransport) -> list[torch.Tensor]:
    """OptCC AllReduce over a list of leaves per member: flatten-concat in
    fp32, one collective, split, cast back. `members` yields p leaf lists
    of equal shapes; returns the summed leaves, which every member holds
    after the collective. The buffer is padded to a multiple of 4 (p - 1)
    fp32 elements, not only of p - 1: each of the p - 1 chunks is then a
    whole number of 16-byte vectors, so every row that the pair-form
    kernel adds starts 16-byte aligned (on an H100 it took 3x as long at
    internlm2-1.8b's odd chunk length)."""
    bufs, layout = _pack(members, tr.p, torch.float32,
                         4 * max(tr.p - 1, 1))
    buf = bufs[torch.float32]
    optcc_allreduce_(buf, straggler, tr)
    return _unpack({torch.float32: buf[0]}, layout)
