"""Single-process transport: p DP members as rows of one tensor.

With one GPU, this stands in for `shard_map` over a 1-D DP axis: member
i's data is index i of a tensor's leading dimension, all on one device,
and a `lax.ppermute` hop becomes row movement inside that tensor. A
member's vector is cut into equal chunks, so a buffer is viewed as
(p, n_chunks, c) and a move names (src member, src chunk, dst member, dst
chunk). Two kinds of move exist:

* `accumulate` - the receiver adds the payload into its chunk; all moves
  of one hop go through one chunk_reduce pair-form launch;
* `copy` - the receiver stores the payload (allgather hops, the return to
  the straggler): plain row copies, as ppermute is data movement.

The transport counts the elements sent over every (src, dst) link, which
is how the tests check that the straggler's link carries the Lemma-5
minimum.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.chunk_reduce import chunk_reduce_pairs_

Move = tuple[int, int, int, int]   # (src member, src chunk, dst member, dst chunk)


class LocalTransport:
    def __init__(self, p: int):
        if p < 1:
            raise ValueError(f"need at least one member, got p={p}")
        self.p = p
        self.link_elems = np.zeros((p, p), np.int64)   # [src, dst]

    def reset_counts(self) -> None:
        self.link_elems[:] = 0

    def link_load(self, member: int) -> int:
        """Elements sent or received by `member` over all its links."""
        return int(self.link_elems[member].sum()
                   + self.link_elems[:, member].sum())

    def _rows(self, buf: torch.Tensor, moves: Sequence[Move]):
        p, nchunks, c = buf.shape
        if p != self.p:
            raise ValueError(f"buffer has {p} members, transport {self.p}")
        src = [s * nchunks + sc for s, sc, _, _ in moves]
        dst = [d * nchunks + dc for _, _, d, dc in moves]
        for s, _, d, _ in moves:
            self.link_elems[s, d] += c
        return buf.view(p * nchunks, c), src, dst

    def accumulate(self, buf: torch.Tensor, moves: Sequence[Move]) -> None:
        """One hop of sends whose receivers add: buf[dst] += buf[src]."""
        rows, src, dst = self._rows(buf, moves)
        chunk_reduce_pairs_(rows, dst, src)

    def copy(self, buf: torch.Tensor, moves: Sequence[Move]) -> None:
        """One hop of sends whose receivers store: buf[dst] = buf[src].
        Destinations and sources must be disjoint, as in `accumulate`."""
        rows, src, dst = self._rows(buf, moves)
        if set(src) & set(dst):
            raise ValueError("copy moves must not read a row they write")
        for s, d in zip(src, dst):
            rows[d].copy_(rows[s])
