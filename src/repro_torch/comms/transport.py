"""Transports: how the DP members' chunks move between them.

A collective (`comms/collectives.py`) is a schedule of hops, each a list of
moves over chunked buffers; a transport executes the hops. Every
per-member tensor has a leading dimension over the members this process
holds (`transport.members`, in that order), and a buffer is viewed as
(members held, n_chunks, width): a move names (src member, src chunk, dst
member, dst chunk), and the first `length` elements of a chunk row are its
payload (the rest pads the row to whole 16-byte vectors, so that every row
the chunk_reduce pair form adds starts 16-byte aligned). Two kinds of
move exist:

* `accumulate` - the receiver adds the payload into its chunk (buf[dst] +=
  buf[src], the receiver's own chunk first, as JAX adds `acc[recv_ix] +
  recv`); the adds of a hop go through one chunk_reduce pair-form launch;
* `copy` - the receiver stores the payload (allgather hops, the return to
  the straggler): plain row copies, as ppermute is data movement.

Two transports:

* `LocalTransport` - all p members as rows of one tensor in one process
  (one GPU standing in for `shard_map` over a 1-D DP axis); a hop is row
  movement inside that tensor.
* `ProcessTransport` - one process per member over `torch.distributed`
  (gloo): a rank holds its own chunks plus one staging row and executes the
  moves of a hop in which it sends or receives as one
  `dist.batch_isend_irecv`. Gloo moves CPU tensors only, so a CUDA member
  stages every hop through pinned host buffers of at most
  `segment_bytes` each (device -> host, gloo, host -> device), segment by
  segment, so that the host memory does not grow with the gradient.

Both count the elements and bytes sent over every (src, dst) link
(`link_elems`, `link_bytes`), which is how the tests check that the
straggler's link carries the Lemma-5 minimum; a process counts the moves it
sends or receives.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.chunk_reduce import chunk_reduce_pairs_

Move = tuple[int, int, int, int]   # (src member, src chunk, dst member, dst chunk)

# the most bytes one message of a hop stages through host memory at once
SEGMENT_BYTES = 32 << 20


def row_width(length: int, dtype: torch.dtype) -> int:
    """A chunk row's width: `length` rounded up to whole 16-byte vectors."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-length // vec) * vec


def _check_disjoint(moves: Sequence[Move]) -> None:
    """The moves of one hop act at once: no chunk is both read and written,
    and no chunk is written twice."""
    dst = [(d, dc) for _, _, d, dc in moves]
    if len(set(dst)) != len(dst) or set(dst) & {(s, sc) for s, sc, _, _
                                               in moves}:
        raise ValueError("the moves of a hop must be disjoint: distinct "
                         "destination chunks, none of them a source")


class _Counts:
    """Elements and bytes sent over each (src, dst) link, by global member
    id; shared by a transport and the transports of its subgroups."""

    def __init__(self, p: int):
        self.elems = np.zeros((p, p), np.int64)
        self.bytes = np.zeros((p, p), np.int64)


class _Transport:
    """What both transports share: the members' global ids and the link
    counts."""

    def __init__(self, ids: Sequence[int], counts: _Counts):
        self.ids = tuple(ids)       # global id of each member of this group
        self.p = len(self.ids)
        self._counts = counts

    @property
    def link_elems(self) -> np.ndarray:   # [src, dst], global ids
        return self._counts.elems

    @property
    def link_bytes(self) -> np.ndarray:
        return self._counts.bytes

    def reset_counts(self) -> None:
        self._counts.elems[:] = 0
        self._counts.bytes[:] = 0

    def link_load(self, member: int) -> int:
        """Elements sent or received by global member `member` over all its
        links."""
        return int(self.link_elems[member].sum()
                   + self.link_elems[:, member].sum())

    def _counted(self, s: int, d: int) -> bool:
        raise NotImplementedError

    def count(self, moves: Sequence[Move], length: int,
              itemsize: int) -> None:
        """Add `length` elements of `itemsize` bytes per move to the links
        it crosses (a move within one member crosses none)."""
        for s, _, d, _ in moves:
            if s != d and self._counted(s, d):
                gs, gd = self.ids[s], self.ids[d]
                self._counts.elems[gs, gd] += length
                self._counts.bytes[gs, gd] += length * itemsize

    def combine(self, fn, *args):
        """fn(*args): a combine of the last hop (timed by ProcessTransport)."""
        return fn(*args)


class LocalTransport(_Transport):
    """All p members in this process, as rows of one tensor."""

    def __init__(self, p: int, *, ids: Optional[Sequence[int]] = None,
                 counts: Optional[_Counts] = None):
        if p < 1:
            raise ValueError(f"need at least one member, got p={p}")
        ids = tuple(range(p)) if ids is None else tuple(ids)
        super().__init__(ids, counts or _Counts(max(ids) + 1))
        self.members = tuple(range(p))

    def _counted(self, s: int, d: int) -> bool:
        return True

    def buffer(self, n_chunks: int, length: int, dtype: torch.dtype,
               device) -> torch.Tensor:
        """(p, n_chunks, row_width(length)); zero past `length`, the
        payload itself uninitialised."""
        w = row_width(length, dtype)
        buf = torch.empty((self.p, n_chunks, w), dtype=dtype, device=device)
        buf[..., length:].zero_()
        return buf

    def _rows(self, buf: torch.Tensor, moves: Sequence[Move],
              length: Optional[int]):
        p, nchunks, w = buf.shape
        if p != self.p:
            raise ValueError(f"buffer has {p} members, transport {self.p}")
        self.count(moves, w if length is None else length,
                   buf.element_size())
        return (buf.view(p * nchunks, w),
                [s * nchunks + sc for s, sc, _, _ in moves],
                [d * nchunks + dc for _, _, d, dc in moves])

    def accumulate(self, buf: torch.Tensor, moves: Sequence[Move],
                   length: Optional[int] = None) -> None:
        """One hop of sends whose receivers add: buf[dst] += buf[src], one
        pair-form launch over the whole rows (their padding is zero)."""
        rows, src, dst = self._rows(buf, moves, length)
        chunk_reduce_pairs_(rows, dst, src)

    def copy(self, buf: torch.Tensor, moves: Sequence[Move],
             length: Optional[int] = None) -> None:
        """One hop of sends whose receivers store: buf[dst] = buf[src] for
        the first `length` elements of each row; destinations and sources
        must be disjoint, as in `accumulate`."""
        _check_disjoint(moves)
        length = buf.shape[-1] if length is None else length
        self.count(moves, length, buf.element_size())
        for s, sc, d, dc in moves:
            buf[d, dc, :length].copy_(buf[s, sc, :length])

    def split(self, groups: Sequence[Sequence[int]]):
        """[(group, transport over its members)] for each group; member j
        of a group's transport is group[j]."""
        return [(tuple(g), LocalTransport(len(g), ids=[self.ids[m] for m in g],
                                          counts=self._counts))
                for g in groups]


class ProcessTransport(_Transport):
    """This process is one member of a torch.distributed group (gloo).

    Made after `dist.init_process_group` (see `comms/dist.py`), by every
    rank; `members` is (this rank's position,). `hops` records each hop
    executed here: its kind, bytes out and in, seconds staging through host
    memory, seconds waiting on gloo, and the CUDA-event milliseconds of its
    combine (chunk_reduce), read by `hop_stats`.
    """

    def __init__(self, segment_bytes: int = SEGMENT_BYTES, *, group=None,
                 ids: Optional[Sequence[int]] = None,
                 counts: Optional[_Counts] = None, _root=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessTransport needs an initialised "
                               "process group (repro_torch.comms.dist)")
        world = dist.get_world_size()
        ids = tuple(range(world)) if ids is None else tuple(ids)
        super().__init__(ids, counts or _Counts(world))
        if segment_bytes < 16 or segment_bytes % 16:
            raise ValueError("segment_bytes must be a positive multiple of 16")
        self.segment_bytes = segment_bytes
        self.group = group
        self.rank = ids.index(dist.get_rank())
        self.members = (self.rank,)
        self._root = _root or self
        if _root is None:
            self._host = {}         # (direction, slot) -> host buffer
            self._groups = {}       # member ids -> process group
            self.hops = []

    def _counted(self, s: int, d: int) -> bool:
        return self.rank in (s, d)

    def buffer(self, n_chunks: int, length: int, dtype: torch.dtype,
               device) -> torch.Tensor:
        """(1, n_chunks + 1, row_width(length)): this member's chunks and,
        as the last row, the staging row that `accumulate` receives into;
        zero past `length`, the payload itself uninitialised."""
        w = row_width(length, dtype)
        buf = torch.empty((1, n_chunks + 1, w), dtype=dtype, device=device)
        buf[..., length:].zero_()
        return buf

    # -- one hop ---------------------------------------------------------

    def _host_view(self, key, like: torch.Tensor) -> torch.Tensor:
        """A host buffer for segment traffic (pinned for a CUDA tensor),
        viewed as `like`'s dtype and length."""
        root = self._root
        buf = root._host.get(key)
        if buf is None:
            buf = torch.empty(self.segment_bytes, dtype=torch.uint8,
                              pin_memory=like.is_cuda)
            root._host[key] = buf
        return buf[:like.numel() * like.element_size()].view(like.dtype)

    def _hop(self, kind: str, sends, recvs) -> dict:
        """Send each (peer, tensor) of `sends` and receive each of `recvs`
        (1-D contiguous tensors; peers are member positions), segment by
        segment through host buffers, one batch_isend_irecv a segment.
        Messages between one pair go in list order on both sides."""
        import torch.distributed as dist
        rec = {"kind": kind, "bytes_out": 0, "bytes_in": 0, "stage_s": 0.0,
               "wait_s": 0.0, "combine_ms": 0.0, "_events": []}
        tensors = [t for _, t in sends] + [t for _, t in recvs]
        if not tensors:
            return rec
        self._root.hops.append(rec)
        n_seg = max(-(-t.numel() * t.element_size() // self.segment_bytes)
                    for t in tensors)
        for k in range(n_seg):
            ops, landed = [], []
            t0 = time.perf_counter()
            for direction, pairs in (("send", sends), ("recv", recvs)):
                for slot, (peer, t) in enumerate(pairs):
                    per = self.segment_bytes // t.element_size()
                    piece = t[k * per:(k + 1) * per]
                    if piece.numel() == 0:
                        continue
                    host = self._host_view((direction, slot), piece)
                    if direction == "send":
                        host.copy_(piece)
                        rec["bytes_out"] += host.numel() * host.element_size()
                        op = dist.isend
                    else:
                        landed.append((piece, host))
                        rec["bytes_in"] += host.numel() * host.element_size()
                        op = dist.irecv
                    ops.append(dist.P2POp(op, host, self.ids[peer],
                                          group=self.group))
            t1 = time.perf_counter()
            for work in dist.batch_isend_irecv(ops) if ops else ():
                work.wait()
            t2 = time.perf_counter()
            for piece, host in landed:
                piece.copy_(host)
            rec["stage_s"] += (t1 - t0) + (time.perf_counter() - t2)
            rec["wait_s"] += t2 - t1
        return rec

    def combine(self, fn, *args):
        """fn(*args), between CUDA events on a CUDA member; the time goes
        to the last hop's record."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or not tensors[0].is_cuda or not self._root.hops:
            return fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self._root.hops[-1]["_events"].append((start, end))
        return out

    def hop_stats(self) -> list[dict]:
        """The hops executed since the last reset_counts, their combine
        milliseconds read from the CUDA events (this synchronises)."""
        out = []
        for rec in self._root.hops:
            rec = dict(rec)
            events = rec.pop("_events")
            if events:
                torch.cuda.synchronize()
                rec["combine_ms"] = sum(s.elapsed_time(e) for s, e in events)
            out.append(rec)
        return out

    def reset_counts(self) -> None:
        super().reset_counts()
        self._root.hops.clear()

    # -- moves -----------------------------------------------------------

    def _check(self, buf: torch.Tensor, moves: Sequence[Move]):
        if buf.dim() != 3 or buf.shape[0] != 1:
            raise ValueError(f"a process holds one member's chunks, got a "
                             f"buffer of shape {tuple(buf.shape)}")
        for m in moves:
            if not all(0 <= m[i] < self.p for i in (0, 2)):
                raise IndexError(f"move {m} names a member outside "
                                 f"0..{self.p - 1}")

    def accumulate(self, buf: torch.Tensor, moves: Sequence[Move],
                   length: Optional[int] = None) -> None:
        """One hop of sends whose receivers add. Each receive lands in the
        staging row (buf's last) and one pair-form launch adds it into its
        chunk; a member that receives several chunks in the hop takes them
        in rounds, one a round, in move order."""
        self._check(buf, moves)
        _check_disjoint(moves)
        staging = buf.shape[1] - 1
        if any(m[1] >= staging or m[3] >= staging for m in moves):
            raise IndexError("a move names the staging row")
        length = buf.shape[-1] if length is None else length
        self.count(moves, length, buf.element_size())
        rounds: dict[int, list] = {}
        seen: dict[int, int] = {}
        for m in moves:
            seen[m[2]] = seen.get(m[2], -1) + 1
            rounds.setdefault(seen[m[2]], []).append(m)
        rows = buf[0]
        for r in sorted(rounds):
            sends = [(d, rows[sc, :length]) for s, sc, d, _ in rounds[r]
                     if s == self.rank]
            recv = [(s, dc) for s, _, d, dc in rounds[r] if d == self.rank]
            self._hop("accumulate", sends,
                      [(s, rows[staging, :length]) for s, _ in recv])
            for _, dc in recv:
                self.combine(chunk_reduce_pairs_, rows, [dc], [staging])

    def copy(self, buf: torch.Tensor, moves: Sequence[Move],
             length: Optional[int] = None,
             out: Optional[torch.Tensor] = None) -> None:
        """One hop of sends whose receivers store: out[dst] = buf[src] for
        the first `length` elements of each row, received straight into
        the destination row (out defaults to buf)."""
        self._check(buf, moves)
        if out is None:
            _check_disjoint(moves)
            out = buf
        self._check(out, moves)
        length = buf.shape[-1] if length is None else length
        self.count(moves, length, buf.element_size())
        src, dst = buf[0], out[0]
        sends, recvs = [], []
        for s, sc, d, dc in moves:
            if s == d == self.rank:
                dst[dc, :length].copy_(src[sc, :length])
            elif s == self.rank:
                sends.append((d, src[sc, :length]))
            elif d == self.rank:
                recvs.append((s, dst[dc, :length]))
        self._hop("copy", sends, recvs)

    def split(self, groups: Sequence[Sequence[int]]):
        """[(group, transport over its members)] for the group that holds
        this member; member j of that transport is group[j]. Every rank
        makes the process group of every group, in order (dist.new_group
        is collective), once per transport tree."""
        import torch.distributed as dist
        out = []
        for g in groups:
            g = tuple(g)
            ids = tuple(self.ids[m] for m in g)
            pg = self._root._groups.get(ids)
            if pg is None:
                pg = self._root._groups[ids] = dist.new_group(list(ids))
            if self.rank in g:
                out.append((g, ProcessTransport(
                    self.segment_bytes, group=pg, ids=ids,
                    counts=self._counts, _root=self._root)))
        return out
