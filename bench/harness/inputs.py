"""Inputs made from --seed on the device: the parameters in the layout of
`reference.decoder.param_layout`, the token batches and the members'
gradients. Each comes from a generator of its own, seeded from (seed,
name), in one large draw per dtype, so the same seed gives the same
tensors, bit for bit, to the program and to the reference."""
from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, name: str) -> int:
    """A 60-bit seed for the generator of `name`, from any whole seed."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).hexdigest()
    return int(digest[:15], 16)


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, name))
    return gen


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def params(layout: dict, seed: int, device) -> dict:
    """{name: tensor} per `layout` ({name: (shape, dtype name, std)}): one
    standard normal draw over all leaves of a dtype, each leaf a view of it
    scaled by its std (zeros where the std is 0)."""
    out = {}
    for dt in sorted({d for _, d, _ in layout.values()}):
        names = [k for k, (_, d, _) in layout.items() if d == dt]
        sizes = [torch.Size(layout[k][0]).numel() for k in names]
        flat = torch.empty(sum(sizes), dtype=_dtype(dt), device=device)
        flat.normal_(generator=generator(seed, f"params.{dt}", device))
        for k, piece in zip(names, flat.split(sizes)):
            shape, _, std = layout[k]
            leaf = piece.view(shape)
            if std:
                leaf.mul_(std)
            else:
                leaf.zero_()
            out[k] = leaf
    return dict(sorted(out.items()))


def token_batches(seed: int, n: int, rows: int, seq_len: int, vocab: int,
                  device) -> torch.Tensor:
    """(n, rows, seq_len + 1) uniform token ids: batch i's tokens are
    [..., :-1] and its labels [..., 1:]."""
    return torch.randint(0, vocab, (n, rows, seq_len + 1),
                         generator=generator(seed, "tokens", device),
                         device=device)


def member_grads(layout: dict, seed: int, dp: int, dtype: str, scale: float,
                 device) -> tuple[torch.Tensor, list]:
    """The dp members' gradient leaf lists of `layout`'s shapes, all in
    `dtype`: one (dp, n) normal draw, leaf k of member i a view of row i
    scaled by scale x its std (1 for a norm). Returns (the flat (dp, n)
    tensor, [member i's leaves in layout order])."""
    shapes = [torch.Size(s) for s, _, _ in layout.values()]
    stds = [std or 1.0 for _, _, std in layout.values()]
    sizes = [s.numel() for s in shapes]
    flat = torch.empty((dp, sum(sizes)), dtype=_dtype(dtype), device=device)
    flat.normal_(generator=generator(seed, "grads", device))
    members = []
    for row in flat:
        leaves = []
        for piece, shape, std in zip(row.split(sizes), shapes, stds):
            leaves.append(piece.mul_(scale * std).view(shape))
        members.append(leaves)
    return flat, members
