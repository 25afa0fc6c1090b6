"""AdamW with configurable moment dtype and global-norm clipping (the port
of `repro/optim/adamw.py`).

Unlike the JAX version, which returns new pytrees, this one updates the
parameters, the moments and (when clipping) the gradients in place, to
keep a 1.7B-parameter model's optimizer within one card's memory; the
arithmetic and its order follow the JAX version: every leaf is decayed,
clipping comes before the moments, the reported norm is the pre-clip norm
and the bias correction is computed in fp32 from an int32 count.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    any_leaf = next(iter(params.values()))
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=any_leaf.device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    sq = [x.float().square().sum() for x in tree.values()]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale `grads` in place so their global norm is at most `max_norm`;
    returns (grads, pre-clip norm)."""
    norm = global_norm(grads)
    limit = torch.full_like(norm, max_norm)     # a true division, as in JAX
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x itself when fp32 (so in-place ops reach x), else an fp32 copy."""
    return x if x.dtype == torch.float32 else x.float()


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, lr, cfg: AdamWConfig):
    """One AdamW step, in place. Returns (params, state, grad_norm): the
    objects passed in, updated."""
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for name, p in params.items():
        gf = grads[name].float()
        mu, nu = state["mu"][name], state["nu"][name]
        mu32, nu32, p32 = _f32(mu), _f32(nu), _f32(p)
        mu32.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
        nu32.mul_(cfg.b2).add_(gf.mul(1 - cfg.b2).mul_(gf))
        step = (mu32 / b1c).div_((nu32 / b2c).sqrt_().add_(cfg.eps))
        step.add_(p32 * cfg.weight_decay).mul_(lr)
        p32.sub_(step)
        for dst, src in ((p, p32), (mu, mu32), (nu, nu32)):
            if dst is not src:
                dst.copy_(src)
    state["count"] = count
    return params, state, gnorm
