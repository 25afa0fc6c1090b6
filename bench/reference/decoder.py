"""Plain reference of the decoder that the benchmark trains.

Written from the configuration file alone (Hugging Face key names), in
plain PyTorch, float32 throughout: no kernel, no cache, no batching
tricks. It takes the parameters in the layout the benchmark hands to the
program (one flat dict, layer weights stacked as (L, ...)), upcast to
float32 by the caller, and works everything else out again.

The layer equations are the measured program's, which depart from the
published models in ways the configuration file lists under `departures`:
RMSNorm scales by (1 + w); RoPE rotates the split halves of a head;
grouped kv heads serve consecutive query heads; the MoE FFN routes each
token to its top-k experts by a softmax over the router logits,
renormalised, and drops the slots past each expert's capacity in a batch
row (slots taken in the order token, then rank).

`mm` is the one matrix product of every linear layer (projections, MLP,
experts, output head) and `act` is applied where the residual stream is
stored, so that the control can put a lower precision in their place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def widths(cfg: dict) -> dict:
    """The sizes the equations need, from the configuration's keys."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": heads,
            "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // heads,
            "f": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "E": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0)}


def param_layout(cfg: dict) -> dict:
    """{name: (shape, dtype name, init std)} of every parameter, sorted by
    name; an std of 0 means zeros (the norms' offsets from 1)."""
    w = widths(cfg)
    d, L, H, KV, hd, f, V, E = (w[x] for x in ("d", "L", "H", "KV", "hd",
                                               "f", "V", "E"))
    pd = cfg["param_dtype"]
    lay = {"blocks/ln1": ((L, d), pd, 0.0),
           "blocks/ln2": ((L, d), pd, 0.0),
           "blocks/wq": ((L, d, H * hd), pd, d ** -0.5),
           "blocks/wk": ((L, d, KV * hd), pd, d ** -0.5),
           "blocks/wv": ((L, d, KV * hd), pd, d ** -0.5),
           "blocks/wo": ((L, H * hd, d), pd, (H * hd) ** -0.5),
           "embed": ((V, d), pd, 0.02),
           "final_norm": ((d,), pd, 0.0),
           "lm_head": ((d, V), pd, d ** -0.5)}
    if E:
        lay.update({"blocks/router": ((L, d, E), cfg["router_dtype"],
                                      d ** -0.5),
                    "blocks/e_gate": ((L, E, d, f), pd, d ** -0.5),
                    "blocks/e_up": ((L, E, d, f), pd, d ** -0.5),
                    "blocks/e_down": ((L, E, f, d), pd, f ** -0.5)})
    else:
        lay.update({"blocks/w_gate": ((L, d, f), pd, d ** -0.5),
                    "blocks/w_up": ((L, d, f), pd, d ** -0.5),
                    "blocks/w_down": ((L, f, d), pd, f ** -0.5)})
    return dict(sorted(lay.items()))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) rotated by position 0 .. S-1; the angles in
    float64, then float32."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention; q (B, S, H, hd), k and v (B, S, KV, hd),
    kv head j serving query heads j rep .. j rep + rep - 1."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = s.masked_fill(~mask, float("-inf")).softmax(-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def capacity(cfg: dict, seq_len: int) -> int:
    """Slots per expert and batch row: cf k S / E rounded half to even,
    at least 1."""
    w = widths(cfg)
    return max(round(cfg["capacity_factor"] * w["k"] * seq_len / w["E"]), 1)


def route(cfg: dict, x: torch.Tensor, router: torch.Tensor):
    """(gates (B, S k), experts (B, S k), kept (B, S k)) of each row's
    token-rank slots, slot s k + j for token s's j-th expert."""
    B, S, _ = x.shape
    k, E = widths(cfg)["k"], widths(cfg)["E"]
    probs = (x @ router).softmax(-1)
    topv, topi = probs.topk(k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = topi.reshape(B, S * k)
    onehot = F.one_hot(experts, E)
    pos = (onehot.cumsum(1) - 1).gather(2, experts[..., None])[..., 0]
    return topv.reshape(B, S * k), experts, pos < capacity(cfg, S)


def moe_ffn(cfg: dict, x, router, e_gate, e_up, e_down, mm=fp32_mm,
            stats=None):
    """`stats`, where given, adds up the slots routed and kept and the
    capacity slots offered."""
    B, S, d = x.shape
    k, E = widths(cfg)["k"], widths(cfg)["E"]
    gates, experts, kept = route(cfg, x, router)
    if stats is not None:
        for key, n in (("routed_slots", experts.numel()),
                       ("kept_slots", int(kept.sum())),
                       ("capacity_slots", E * B * capacity(cfg, S))):
            stats[key] = stats.get(key, 0) + n
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slots = ((experts == e) & kept).nonzero(as_tuple=True)
        toks = slots // k
        xe = x[rows, toks]
        ye = mm(F.silu(mm(xe, e_gate[e])) * mm(xe, e_up[e]), e_down[e])
        out = out.index_put((rows, toks), ye * gates[rows, slots][:, None],
                            accumulate=True)
    return out


def loss(cfg: dict, p: dict, tokens: torch.Tensor, labels: torch.Tensor,
         mm=fp32_mm, act=None, stats=None) -> torch.Tensor:
    """Mean next-token cross-entropy of `labels` (B, S) after `tokens`
    (B, S); p holds float32 parameters in `param_layout`'s names. `stats`
    as in `moe_ffn`."""
    w = widths(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    act = act or (lambda x: x)
    B, S = tokens.shape
    x = act(p["embed"][tokens])
    for l in range(w["L"]):
        h = rms_norm(x, p["blocks/ln1"][l], eps)
        q = mm(h, p["blocks/wq"][l]).view(B, S, w["H"], w["hd"])
        k = mm(h, p["blocks/wk"][l]).view(B, S, w["KV"], w["hd"])
        v = mm(h, p["blocks/wv"][l]).view(B, S, w["KV"], w["hd"])
        o = attention(rope(q, theta), rope(k, theta), v)
        x = act(x + mm(o.reshape(B, S, -1), p["blocks/wo"][l]))
        h = rms_norm(x, p["blocks/ln2"][l], eps)
        if w["E"]:
            f = moe_ffn(cfg, h, p["blocks/router"][l], p["blocks/e_gate"][l],
                        p["blocks/e_up"][l], p["blocks/e_down"][l], mm, stats)
        else:
            f = mm(F.silu(mm(h, p["blocks/w_gate"][l]))
                   * mm(h, p["blocks/w_up"][l]), p["blocks/w_down"][l])
        x = act(x + f)
    x = rms_norm(x, p["final_norm"], eps)
    logits = mm(x, p["lm_head"])
    return F.cross_entropy(logits.reshape(B * S, -1), labels.reshape(-1))
