"""Software collectives: the paper's schedules over the DP members of a
transport (the port of `repro/comms/collectives.py`).

A DP-sharded value is a tensor whose leading dimension runs over the
members the transport holds (`transport.members`): all p of a
`LocalTransport`, one of a `ProcessTransport`. x (k, n) holds member
`members[r]`'s vector in row r, and a collective returns (k, ...) with that
member's result in row r. The schedules are written once, as hops of moves
(`comms/transport.py`), and run unchanged on either transport. Every
combine is the chunk_reduce kernel: psum's is its W-way form, each
reduce-scatter hop and the straggler fold one launch of its in-place pair
form.

  * psum - lax.psum: the (n,) sum every member holds;
  * ring_reduce_scatter / ring_all_gather / ring_allreduce - the NCCL ring
    baseline (Patarasuk-Yuan): at step t member i sends chunk (i - t).
  * optcc_allreduce - OptCC's stage structure for one degraded member: the
    straggler's vector enters the healthy subring once, the p-1 healthy
    members reduce-scatter + allgather among themselves, and one flow
    returns the result to the straggler. The straggler's link carries 2n
    elements total - the information-theoretic minimum (Lemma 5) - instead
    of the 2n(p-1)/p it would carry inside a symmetric ring.
  * hierarchical_psum - psum within each inner group, then across groups;
  * quantize_int8 / dequantize_int8 / compressed_psum - the reduce-scatter
    at full precision, the all-gather in int8, with error feedback.

Padding, chunk boundaries, ring positions and chunk ownership follow the
JAX functions, and so does every addition's operand pair, so in fp32 the
ring and OptCC results (flat and tree) agree with them bit for bit. Each
chunk lies in its own row, padded to whole 16-byte vectors, so the pair
form's rows start 16-byte aligned whatever the chunk length.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from repro_torch.kernels.chunk_reduce import chunk_reduce


# ----------------------------------------------------------------------------
# psum: one W-way launch where every member is here, else a direct
# reduce-scatter and all-gather between the processes
# ----------------------------------------------------------------------------

def _owner_moves(p: int) -> list:
    """The direct reduce-scatter: member j's chunk i goes to row j of member
    i's (p, c) stack (j == i: a copy within the member)."""
    return [(j, i, i, j) for i in range(p) for j in range(p)]


def _gather_moves(p: int) -> list:
    """The direct all-gather: member i's chunk goes to chunk i of every
    member."""
    return [(i, 0, j, i) for i in range(p) for j in range(p)]


def _direct_reduce_scatter(x: torch.Tensor, tr) -> torch.Tensor:
    """x (k, p c) -> (k, c): member i holds sum_j x_j's chunk i
    (psum_scatter's ownership), summed by one W-way launch over the p rows
    in member order, fp32 accumulation, one rounding to x's dtype. With
    every member here, one launch sums every chunk; the links are counted
    as the process transport moves them."""
    k, n = x.shape
    p = tr.p
    c = n // p
    chunks = x.view(k, p, c)
    if k == p:
        tr.count(_owner_moves(p), c, x.element_size())
        return tr.combine(chunk_reduce, x, x.dtype).view(p, c)
    stack = torch.empty((k, p, c), dtype=x.dtype, device=x.device)
    tr.copy(chunks, _owner_moves(p), c, out=stack)
    return torch.stack([tr.combine(chunk_reduce, s, x.dtype) for s in stack])


def _direct_all_gather(shard: torch.Tensor, tr) -> torch.Tensor:
    """shard (k, c), member i's chunk i -> (k, p, c), every member every
    chunk."""
    k, c = shard.shape
    p = tr.p
    out = torch.empty((k, p, c), dtype=shard.dtype, device=shard.device)
    if k == p:
        tr.count(_gather_moves(p), c, shard.element_size())
        out[:] = shard
        return out
    tr.copy(shard.view(k, 1, c), _gather_moves(p), c, out=out)
    return out


def _pad(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[-1]
    if n % multiple == 0:
        return x
    out = x.new_zeros(x.shape[:-1] + (n + (-n) % multiple,))
    out[..., :n] = x
    return out


def psum(x: torch.Tensor, tr=None) -> torch.Tensor:
    """x: (k, n) -> (n,), the sum every member holds (lax.psum), in x's
    dtype with fp32 accumulation and one rounding. Without a transport, or
    with every member here, one W-way launch over the rows; between
    processes, a direct reduce-scatter (member i sums chunk i of the p
    vectors with one W-way launch over a (p, c) stack in member order) and
    a direct all-gather: the same additions in the same order, so the
    result is the same to the bit in fp32 and bf16 alike."""
    if tr is None:
        return chunk_reduce(x, out_dtype=x.dtype)
    n = x.shape[-1]
    if x.shape[0] != len(tr.members):
        raise ValueError(f"x has {x.shape[0]} rows, the transport holds "
                         f"{len(tr.members)} members")
    if len(tr.members) == tr.p:
        tr.count(_owner_moves(tr.p) + _gather_moves(tr.p), -(-n // tr.p),
                 x.element_size())
        return tr.combine(chunk_reduce, x, x.dtype)
    xp = _pad(x, tr.p)
    shard = _direct_reduce_scatter(xp, tr)
    return _direct_all_gather(shard, tr)[0].reshape(-1)[:n]


# ----------------------------------------------------------------------------
# ring and OptCC: hops of moves over chunked buffers
# ----------------------------------------------------------------------------

def _reduce_scatter_(tr, acc: torch.Tensor, ring: Sequence[int],
                     length: int) -> None:
    """In place on acc (k, m', w) over the members of `ring` (m of them,
    in ring order): afterwards ring[i] holds the full sum of chunk
    (i+1) % m."""
    m = len(ring)
    for t in range(m - 1):
        tr.accumulate(acc, [(ring[i], (i - t) % m, ring[(i + 1) % m],
                             (i - t) % m) for i in range(m)], length)


def _all_gather_(tr, acc: torch.Tensor, ring: Sequence[int],
                 length: int) -> None:
    """In place: ring[i] starts with chunk (i+1) % m final and ends with
    every chunk, each received from its predecessor."""
    m = len(ring)
    for t in range(m - 1):
        tr.copy(acc, [(ring[i], (i + 1 - t) % m, ring[(i + 1) % m],
                       (i + 1 - t) % m) for i in range(m)], length)


def _chunks_in(tr, x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """x (k, n_chunks c) as a transport buffer of n_chunks rows of c."""
    k, n = x.shape
    c = n // n_chunks
    buf = tr.buffer(n_chunks, c, x.dtype, x.device)
    buf[:, :n_chunks, :c] = x.view(k, n_chunks, c)
    return buf


def ring_reduce_scatter(x: torch.Tensor, tr) -> torch.Tensor:
    """x: (k, n), n % p == 0 -> (k, n/p): member i holds chunk (i+1) mod p
    of sum_j x_j."""
    p, n = tr.p, x.shape[1]
    if n % p:
        raise ValueError("pad the vector to a multiple of the axis size")
    c = n // p
    acc = _chunks_in(tr, x, p)
    _reduce_scatter_(tr, acc, range(p), c)
    return torch.stack([acc[r, (m + 1) % p, :c]
                        for r, m in enumerate(tr.members)])


def ring_all_gather(chunks: torch.Tensor, tr) -> torch.Tensor:
    """Inverse of ring_reduce_scatter: (k, c) -> (k, p c), member i
    contributes chunk (i+1)."""
    k, c = chunks.shape
    p = tr.p
    out = tr.buffer(p, c, chunks.dtype, chunks.device)
    for r, m in enumerate(tr.members):
        out[r, (m + 1) % p, :c] = chunks[r]
    _all_gather_(tr, out, range(p), c)
    return out[:, :p, :c].reshape(k, p * c)


def ring_allreduce(x: torch.Tensor, tr) -> torch.Tensor:
    """Reference ring AllReduce (== psum) built from the two halves."""
    return ring_all_gather(ring_reduce_scatter(x, tr), tr)


def optcc_allreduce_(buf: torch.Tensor, straggler: int, tr,
                     length: int) -> torch.Tensor:
    """OptCC AllReduce in place on a transport buffer of p - 1 chunks of
    `length` (the caller padded the vector with zeros to (p-1) length, as
    JAX does); every member's chunks end holding the sum."""
    p = tr.p
    _check_optcc(p, straggler)
    ph = p - 1
    healthy = [r for r in range(p) if r != straggler]
    peer = healthy[0]
    # Stage "S3'" (ordering B): straggler -> peer; peer folds it in.
    tr.accumulate(buf, [(straggler, j, peer, j) for j in range(ph)], length)
    # Stages S1/S4 on the healthy subring; healthy[i] plays position i.
    _reduce_scatter_(tr, buf, healthy, length)
    _all_gather_(tr, buf, healthy, length)
    # Stage "S2'": one healthy member returns the sum to the straggler.
    tr.copy(buf, [(peer, j, straggler, j) for j in range(ph)], length)
    return buf


def _check_optcc(p: int, straggler: int) -> None:
    if p < 3:
        raise ValueError("optcc_allreduce needs axis size >= 3")
    if not 0 <= straggler < p:
        raise ValueError(f"straggler {straggler} outside 0..{p - 1}")


def _optcc_chunks(n: int, p: int) -> tuple[int, int]:
    """JAX's OptCC chunking of an n vector: padded to a multiple of p - 1,
    (padded length, chunk length)."""
    npad = n + (-n) % (p - 1)
    return npad, npad // (p - 1)


def optcc_allreduce(x: torch.Tensor, straggler: int, tr) -> torch.Tensor:
    """x: (k, n) -> (k, n), every row the sum, where member `straggler` has
    a degraded link: its link carries the vector out once and the sum back
    once (2 npad elements), all other traffic runs on the healthy ring."""
    k, n = x.shape
    _check_optcc(tr.p, straggler)
    npad, c = _optcc_chunks(n, tr.p)
    buf = _chunks_in(tr, _pad(x, tr.p - 1), tr.p - 1)
    optcc_allreduce_(buf, straggler, tr, c)
    return buf[:, :tr.p - 1, :c].reshape(k, npad)[:, :n]


# ----------------------------------------------------------------------------
# lists of leaves
# ----------------------------------------------------------------------------

def _layout(leaves: Sequence[torch.Tensor], dtype: Optional[torch.dtype]):
    """(buffer dtype, offset, shape, dtype) per leaf and the element count
    of each buffer: one buffer of `dtype` for every leaf, or with `dtype`
    None one per leaf dtype, each holding the leaves of its dtype in order."""
    layout, sizes = [], {}
    for leaf in leaves:
        group = dtype or leaf.dtype
        off = sizes.get(group, 0)
        layout.append((group, off, leaf.shape, leaf.dtype))
        sizes[group] = off + leaf.numel()
    return layout, sizes


def _pieces(off: int, size: int, c: int):
    """The pieces of flat range [off, off + size) in rows of c: (row,
    column, offset within the range, length)."""
    pos = off
    while pos < off + size:
        row, col = divmod(pos, c)
        take = min(c - col, off + size - pos)
        yield row, col, pos - off, take
        pos += take


def _pack(members: Iterable[Sequence[torch.Tensor]], k: int,
          dtype: Optional[torch.dtype], new_buffer):
    """Write the leaves of each of the k members held here into member row
    r of per-dtype buffers, consuming the members one at a time (only one
    member's leaves need be alive at once). `new_buffer(n, dtype, device)`
    returns (buffer (k, rows, w), chunk length c) for n elements; a leaf's
    flat range is cut across the rows of c. Returns ({buffer dtype:
    (buffer, c)}, layout)."""
    bufs, layout = None, None
    count = 0
    for r, leaves in enumerate(members):
        if r >= k:
            raise ValueError(f"more than the {k} members held here")
        if bufs is None:
            layout, sizes = _layout(leaves, dtype)
            bufs = {g: new_buffer(n, g, leaves[0].device)
                    for g, n in sizes.items()}
        for (group, off, _, _), leaf in zip(layout, leaves):
            buf, c = bufs[group]
            flat = leaf.reshape(-1)
            for row, col, o, take in _pieces(off, leaf.numel(), c):
                buf[r, row, col:col + take].copy_(flat[o:o + take])
        count += 1
    if count != k:
        raise ValueError(f"expected {k} members, got {count}")
    return bufs, layout


def _unpack(rows: dict, layout) -> list[torch.Tensor]:
    """The leaves of `layout` out of each buffer dtype's summed (rows, w)
    chunks of c, each in its dtype: a view where the leaf lies in one row in
    the buffer's dtype, else a new tensor."""
    out = []
    for group, off, shape, dtype in layout:
        buf, c = rows[group]
        pieces = list(_pieces(off, shape.numel(), c))
        if len(pieces) == 1 and dtype == group:
            row, col, _, take = pieces[0]
            out.append(buf[row, col:col + take].view(shape))
            continue
        leaf = torch.empty(shape, dtype=dtype, device=buf.device)
        flat = leaf.view(-1)
        for row, col, o, take in pieces:
            flat[o:o + take].copy_(buf[row, col:col + take])
        out.append(leaf)
    return out


def psum_tree(members: Iterable[Sequence[torch.Tensor]],
              tr) -> list[torch.Tensor]:
    """lax.psum over a list of leaves per member, each leaf summed in its
    own dtype as JAX psums it: flatten-concat the leaves of each dtype into
    one buffer, one psum per buffer, split. (One buffer in the leaves'
    common dtype would be the same sum, bit for bit - the kernel adds exact
    inputs in fp32 and rounds once - but hymba's bf16 gradients beside its
    fp32 leaves would then take twice the memory.) `members` yields the
    leaf lists of the members held here (`tr.members`), of equal shapes;
    returns the summed leaves every member holds."""
    k = len(tr.members)

    def new_buffer(n, dtype, device):
        npad = n + (-n) % tr.p
        buf = torch.empty((k, 1, npad), dtype=dtype, device=device)
        buf[..., n:].zero_()
        return buf, npad

    bufs, layout = _pack(members, k, None, new_buffer)
    return _unpack({g: (psum(buf[:, 0], tr).view(1, -1), c)
                    for g, (buf, c) in bufs.items()}, layout)


def optcc_allreduce_tree(members: Iterable[Sequence[torch.Tensor]],
                         straggler: int, tr) -> list[torch.Tensor]:
    """OptCC AllReduce over a list of leaves per member: flatten-concat in
    fp32, one collective, split, cast back, as JAX's `optcc_allreduce_tree`
    and to the bit. The vector keeps JAX's p - 1 chunks (padded to a
    multiple of p - 1); each chunk has its own row, padded to whole
    16-byte vectors, so every row the pair-form kernel adds starts 16-byte
    aligned (on an H100 it took 3x as long at internlm2-1.8b's odd chunk
    length with rows off 16-byte phase). `members` yields the leaf lists
    of the members held here, of equal shapes; returns the summed leaves,
    which every member holds after the collective."""
    _check_optcc(tr.p, straggler)
    k, ph = len(tr.members), tr.p - 1

    def new_buffer(n, dtype, device):
        npad, c = _optcc_chunks(n, tr.p)
        buf = tr.buffer(ph, c, dtype, device)
        buf[:, ph - 1, c - (npad - n):c].zero_()
        return buf, c

    bufs, layout = _pack(members, k, torch.float32, new_buffer)
    buf, c = bufs[torch.float32]
    optcc_allreduce_(buf, straggler, tr, c)
    return _unpack({torch.float32: (buf[0], c)}, layout)


# ----------------------------------------------------------------------------
# hierarchical + compressed gradient sync
# ----------------------------------------------------------------------------

def _group_psum(x: torch.Tensor, groups, tr) -> torch.Tensor:
    """Each member's row becomes the psum over its group."""
    out = torch.empty_like(x)
    for group, sub in tr.split(groups):
        rows = [r for r, m in enumerate(tr.members) if m in group]
        out[rows] = psum(x[rows], sub)
    return out


def hierarchical_psum(x: torch.Tensor, inner: int, tr,
                      outer: bool = True) -> torch.Tensor:
    """psum within the pod, then across pods (DCN-friendly ordering). The
    p = outer x inner members form a ('outer', 'inner') mesh, member r at
    (r // inner, r % inner): psum over each inner group, rounded to x's
    dtype, then (with `outer`) over each outer group, as two lax.psum do;
    without `outer` it stops after the first, as JAX with outer_axis=None.
    x: (k, n) -> (k, n)."""
    p = tr.p
    if inner < 1 or p % inner:
        raise ValueError(f"inner size {inner} does not divide p={p}")
    y = _group_psum(x, [range(g * inner, (g + 1) * inner)
                        for g in range(p // inner)], tr)
    if outer:
        y = _group_psum(y, [range(i, p, inner) for i in range(inner)], tr)
    return y


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (scale in fp32); round is
    half to even, as jnp.round."""
    scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, tr,
                    error: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """AllReduce with int8-compressed allgather half + error feedback.

    x (k, n). The reduce-scatter runs at full precision (sums must not
    saturate), member i owning chunk i; each member quantizes its reduced
    shard to int8 and the shards are allgathered at 1/4 the bytes (plus
    one fp32 scale a member). Returns (result, new_error), both (k, n):
    new_error is each member's quantization residual, scattered to full
    length (add it to the next step's gradient - standard error-feedback
    compression)."""
    k, n = x.shape
    p = tr.p
    if error is not None:
        x = x + error
    xp = _pad(x, p)
    c = xp.shape[1] // p
    shard = _direct_reduce_scatter(xp, tr)
    qs, scales = zip(*(quantize_int8(s) for s in shard))
    q, scale = torch.stack(qs), torch.stack(scales)
    # shard - q scale rounded once, as XLA's fused multiply-add computes
    # it: in fp64 the product of an int8 and an fp32 scale is exact, and so
    # is its difference from the fp32 shard that it is within half a scale of
    new_error = (shard.double() - q.double() * scale.double()[:, None]
                 ).to(shard.dtype)
    q_all = _direct_all_gather(q, tr)
    scale_all = _direct_all_gather(scale[:, None], tr)
    full = (q_all.to(torch.float32) * scale_all).reshape(k, p * c)
    err_full = torch.zeros((k, p, c), dtype=new_error.dtype,
                           device=x.device)
    for r, m in enumerate(tr.members):
        err_full[r, m] = new_error[r]
    return full[:, :n], err_full.reshape(k, p * c)[:, :n]
