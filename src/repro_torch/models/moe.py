"""Mixture-of-Experts FFN: top-k routing with a capacity-bounded, row-local
dispatch (the port of `repro/models/moe.py`, for phi3.5-moe: 16 experts
top-2, and arctic-480b: 128 experts top-2 plus a dense residual FFN).

Plain PyTorch, as the JAX package computes its MoE outside any Pallas
kernel. Routing, scatter and combine follow the JAX code step for step,
so the routing (top-k ids, kept slots, slot positions) is the same from
the same router logits: a stable sort of each row's token-expert slots by
expert, each slot's position inside its expert from a left searchsorted,
slots at position >= capacity dropped into an extra slot `cap` that is
thrown away. Each expert's three products are one batched matmul over
the experts with the batch and capacity folded into rows, so an expert's
weights are read once a call. JAX's sharding constraints on the dispatch
buffers (`shardctx.constrain_batch`) only place data on a device mesh;
on one device they do nothing, and the port leaves them out.

The expert leaves are stacked (L, E, d, f) / (L, E, f, d), the router
(L, d, E) in fp32 whatever the parameter dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import init_dense, swiglu, torch_dtype


def init_moe_params(cfg: ModelConfig, generator: torch.Generator,
                    n_layers: int) -> dict:
    """The router and expert leaves (and arctic's dense residual d_gate,
    d_up, d_down) of n_layers layers, with the JAX init's formulas."""
    d, f, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, n_layers
    dt = torch_dtype(cfg.param_dtype)
    p = {"router": init_dense((L, d, E), generator, dtype=torch.float32),
         "e_gate": init_dense((L, E, d, f), generator, dtype=dt),
         "e_up": init_dense((L, E, d, f), generator, dtype=dt),
         "e_down": init_dense((L, E, f, d), generator, dtype=dt)}
    if cfg.moe_dense_ff:
        fd = cfg.moe_dense_ff
        p["d_gate"] = init_dense((L, d, fd), generator, dtype=dt)
        p["d_up"] = init_dense((L, d, fd), generator, dtype=dt)
        p["d_down"] = init_dense((L, fd, d), generator, dtype=dt)
    return p


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert and batch row: round(cf k S / E) with Python's
    round-half-even, as in JAX, and at least 1."""
    return max(int(round(cfg.capacity_factor * cfg.top_k * seq_len
                         / cfg.n_experts)), 1)


class Routing(NamedTuple):
    """One layer's routing of x (B, S, d); Sk = S top_k token-expert slots
    a row, in the stable sort order of their expert ids."""
    topv: torch.Tensor       # (B, S, k) fp32 gates, renormalised
    topi: torch.Tensor       # (B, S, k) expert ids, by falling gate
    order: torch.Tensor      # (B, Sk) flat slot s k + j of each sorted slot
    sorted_e: torch.Tensor   # (B, Sk) expert of each sorted slot
    pos_c: torch.Tensor      # (B, Sk) its position in the expert, cap = drop
    keep: torch.Tensor       # (B, Sk) bool, position < cap
    token_of: torch.Tensor   # (B, Sk) its token
    cap: int


def route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor
          ) -> Routing:
    """fp32 router logits, softmax, top-k renormalised by max(sum, 1e-9),
    and each row's capacity dispatch."""
    B, S, _ = x.shape
    k = cfg.top_k
    gates = (x.float() @ router).softmax(-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, S)
    flat_e = topi.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    first = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(S * k, device=x.device)[None] - first
    keep = pos_in_e < cap
    pos_c = torch.where(keep, pos_in_e, cap)
    return Routing(topv, topi, order, sorted_e, pos_c, keep, order // k,
                   cap)


def moe_ffn(cfg: ModelConfig, x: torch.Tensor, bp: dict) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). bp holds this layer's router, expert
    weights and, for arctic, its dense residual FFN."""
    B, S, d = x.shape
    E = cfg.n_experts
    r = route(cfg, x, bp["router"])
    cap = r.cap
    bidx = torch.arange(B, device=x.device)[:, None]
    keep = r.keep.to(x.dtype)
    vals = x.gather(1, r.token_of[..., None].expand(-1, -1, d))
    buf = x.new_zeros((B, E, cap + 1, d)).index_put(
        (bidx, r.sorted_e, r.pos_c), vals * keep[..., None])
    # (E, B cap, d): every expert's rows of the batch in one matmul each
    rows = buf[:, :, :cap].transpose(0, 1).reshape(E, B * cap, d)
    g = torch.bmm(rows, bp["e_gate"])
    u = torch.bmm(rows, bp["e_up"])
    out_e = torch.bmm(F.silu(g) * u, bp["e_down"])
    out_e = F.pad(out_e.reshape(E, B, cap, d).transpose(0, 1),
                  (0, 0, 0, 1))                          # (B, E, cap+1, d)
    w = r.topv.reshape(B, -1).gather(1, r.order).to(x.dtype)
    contrib = out_e[bidx, r.sorted_e, r.pos_c] * (w * keep)[..., None]
    out = x.new_zeros((B, S, d)).index_put((bidx, r.token_of), contrib,
                                           accumulate=True)
    if cfg.moe_dense_ff:
        out = out + swiglu(x, bp["d_gate"], bp["d_up"], bp["d_down"])
    return out


def aux_load_balance_loss(cfg: ModelConfig, x: torch.Tensor,
                          router: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss for one layer. (As in
    JAX, the model's loss does not add it.)"""
    gates = (x.float() @ router).softmax(-1).reshape(-1, cfg.n_experts)
    frac_tokens = F.one_hot(gates.argmax(-1), cfg.n_experts).float() \
        .mean(0)
    return cfg.n_experts * (frac_tokens * gates.mean(0)).sum()
