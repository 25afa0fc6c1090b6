"""Seeded random directions to read a gradient along.

A leaf's norm misses the direction of its gradient: a sign flipped, or
an error spread evenly over the leaf, can leave the norm as it was. Its
projections onto a few random directions do not: each direction v has
independent standard normal elements, so <a, v> - <b, v> is a normal
number of standard deviation |a - b|. The directions are drawn from the
seed, leaf and block by block, so that the program's side and the
reference's read a gradient along the same ones, bit for bit.
"""
from __future__ import annotations

import hashlib

import torch

COUNT = 4                # directions per leaf
BLOCK = 1 << 24          # elements of a leaf drawn at once


def _seed(seed: int, name: str, block: int) -> int:
    digest = hashlib.sha256(f"{seed}:probe:{name}:{block}".encode())
    return int(digest.hexdigest()[:15], 16)


def project(tensors: dict, seed: int, scale: float = 1.0) -> dict:
    """{name: [COUNT projections]} of each tensor, times `scale`: the
    products in float32, their sums in float64."""
    out = {}
    for name, t in tensors.items():
        flat = t.reshape(-1)
        sums = torch.zeros(COUNT, dtype=torch.float64, device=t.device)
        for block, lo in enumerate(range(0, flat.numel(), BLOCK)):
            piece = flat[lo:lo + BLOCK].float()
            gen = torch.Generator(device=t.device)
            gen.manual_seed(_seed(seed, name, block))
            v = torch.randn((COUNT, piece.numel()), generator=gen,
                            device=t.device)
            sums += (v * piece).sum(1, dtype=torch.float64)
            del v
        out[name] = [s * scale for s in sums.tolist()]
    return out
