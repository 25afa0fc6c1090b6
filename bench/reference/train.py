"""Plain reference of the data-parallel training step: every member's loss
and gradients from `decoder.loss`, their plain sum over the members
divided by their count, and a plain AdamW with global-norm clipping.

Parameters are kept in the configuration's stored dtypes (bf16, the
router in float32) and upcast to float32 for each step; the gradients,
the moments and the update are float32, and the updated parameters are
rounded back to their stored dtype, as the configuration states.

`control="fp8"` is the control: the same step computed in float8 e4m3
where the configuration states bf16, each tensor with one scale (its
largest magnitude onto the format's): the bf16 parameters stored on the
fp8 grid, the residual stream rounded to fp8 where it is stored, and both
operands of every linear layer in fp8, forward and backward, products
accumulated in float32. `control="fp8_operands"` is the second control,
the shortcut nearest to a fast path: fp8 operands of every linear layer
alone, the parameters and the residual stream as the configuration
states.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bench.reference import decoder

F8_MAX = 448.0      # largest finite float8 e4m3fn


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, returned in
    x's dtype (an empty x, such as an expert given no token, as it is)."""
    if not x.numel():
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Round(torch.autograd.Function):
    """Rounds to fp8 forward, and the gradient to fp8 backward."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def fp8_act(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


def _store(p: torch.Tensor, value: torch.Tensor, fp8: bool) -> None:
    """Writes `value` (float32) into the stored parameter p in p's dtype,
    on the fp8 grid first for the control (bf16 leaves only)."""
    p.copy_(to_fp8(value) if fp8 and p.dtype != torch.float32 else value)


CONTROLS = ("fp8", "fp8_operands")


def train_steps(cfg: dict, params: dict, batches, *, dp: int, lr: float,
                adamw: dict, control: Optional[str] = None,
                fault: Optional[str] = None, stats: Optional[dict] = None,
                probe: Optional[Callable] = None) -> dict:
    """Runs len(batches) steps from `params` ({name: tensor in its stored
    dtype}, updated in place). batches: (tokens (GB, S), labels (GB, S))
    per step, member i taking rows [i b, (i+1) b). `control` runs one of
    `CONTROLS`.

    Returns {"loss": [mean member loss per step], "grad_norm": the first
    step's pre-clip global norm, "first_grad": {name: the first step's
    synced gradient's norm, before clipping}, "first_proj": `probe` of
    those gradients ({} without a probe)}.

    `fault` plants one of the faults the check has to catch, in this
    reference put in the program's place: "half_batch" (each member's
    first half of its rows, the mean over them), "no_exchange" (member
    0's gradient and loss alone, as if the members never summed) or
    "altered" (one element of the synced gradient set to 1). `stats`,
    where given, gathers the first step's MoE routing counts."""
    b1, b2, eps = adamw["b1"], adamw["b2"], adamw["eps"]
    wd, clip = adamw["weight_decay"], adamw["clip_norm"]
    if control not in (None, *CONTROLS):
        raise ValueError(f"no control {control!r}")
    fp8 = control == "fp8"
    mm = fp8_mm if control else decoder.fp32_mm
    act = fp8_act if fp8 else None
    mu = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
          for k, v in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    if fp8:
        with torch.no_grad():
            for p in params.values():
                _store(p, p.float(), fp8)
    out = {"loss": [], "grad_norm": None, "first_grad": None,
           "first_proj": {}}
    for t, (tokens, labels) in enumerate(batches, start=1):
        leaves = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                  for k, v in params.items()}
        b = tokens.shape[0] // dp
        members = range(1) if fault == "no_exchange" else range(dp)
        losses = []
        for i in members:
            rows = slice(i * b, i * b + (b // 2 if fault == "half_batch"
                                         else b))
            member_loss = decoder.loss(cfg, leaves, tokens[rows],
                                       labels[rows], mm, act,
                                       stats if t == 1 else None)
            member_loss.backward()
            losses.append(member_loss.item())
        grads = {k: v.grad.div_(len(members)) for k, v in leaves.items()}
        del leaves
        if fault == "altered":
            first = next(iter(grads.values()))
            first.view(-1)[0] = 1.0
        gnorm = math.sqrt(sum(g.double().square().sum().item()
                              for g in grads.values()))
        if t == 1:
            out["grad_norm"] = gnorm
            out["first_grad"] = {k: g.double().norm().item()
                                 for k, g in grads.items()}
            if probe is not None:
                out["first_proj"] = probe(grads)
        scale = min(1.0, clip / max(gnorm, 1e-12))
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for k, p in params.items():
                g = grads.pop(k).mul_(scale)
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                del g
                p32 = p.to(torch.float32, copy=True)
                upd = (mu[k] / c1) / ((nu[k] / c2).sqrt() + eps)
                p32.sub_(lr * (upd + wd * p32))
                _store(p, p32, fp8)
        out["loss"].append(sum(losses) / len(losses))
    return out
