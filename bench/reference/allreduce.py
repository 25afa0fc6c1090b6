"""Plain reference of the AllReduce: the members' leaves summed exactly in
float64, and the error of a result in units in the last place (ulp) of
bf16 at the exact sum.

The configuration states bf16 gradients summed with float32
accumulation and rounded once, so a sound result lies within half an ulp
of the exact sum. Where the members nearly cancel, float32's own rounding
can leave a residue many ulps of a sum near zero, so the ulp is taken at
the larger of |sum| and FLOOR times the largest |member|: the sound
result still reads half an ulp, and the control, `sum_bf16` (the same sum
accumulated in bf16, rounded after every addition), reads up to about
1 / FLOOR.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 26          # elements per block of the float64 work
FLOOR = 2.0 ** -8


def ulp_bf16(y: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |y| (float64): 2^(e - 7) for y in
    [2^e, 2^(e+1)), and the subnormal spacing 2^-133 below 2^-126."""
    e = torch.floor(torch.log2(y.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def max_err_ulp(result: torch.Tensor, members) -> float:
    """max |result - sum of members| / ulp_bf16(max(|sum|, FLOOR x the
    largest |member|)) over every element; result (n,), members a list of
    (n,) tensors, all flat."""
    worst = 0.0
    for lo in range(0, result.numel(), BLOCK):
        hi = min(lo + BLOCK, result.numel())
        exact = members[0][lo:hi].double()
        big = exact.abs()
        for m in members[1:]:
            exact = exact + m[lo:hi].double()
            big = torch.maximum(big, m[lo:hi].double().abs())
        scale = torch.maximum(exact.abs(), FLOOR * big)
        err = (result[lo:hi].double() - exact).abs() / ulp_bf16(scale)
        worst = max(worst, err.max().item())
    return worst


def sum_bf16(members) -> torch.Tensor:
    """The control: members added in order, each partial sum rounded to
    bf16."""
    acc = members[0].to(torch.bfloat16).clone()
    for m in members[1:]:
        acc = (acc.float() + m.float()).to(torch.bfloat16)
    return acc
