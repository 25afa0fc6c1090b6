"""The benchmark's own arithmetic: the card's peaks, a model's FLOPs per
token and the reduction's least bytes. Nothing here reads the program."""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def matmul_weights_per_token(cfg: dict) -> int:
    """Weights of the matrix products one token goes through: attention's
    four projections, the MLP or its top-k experts and the router, every
    layer, and the output head; not the embedding lookup."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    f = cfg["intermediate_size"]
    attn = 2 * d * H * hd + 2 * d * KV * hd
    E = cfg.get("num_local_experts", 0)
    ffn = 3 * d * f * (cfg["num_experts_per_tok"] if E else 1) + d * E
    return L * (attn + ffn) + d * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x the matmul weights a token uses, plus causal attention's
    3 x 4 x heads x hd x the mean number of keys a query sees ((S + 1) / 2)
    per layer; recomputation not counted."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // H
    pairs = (seq_len + 1) / 2
    return (6 * matmul_weights_per_token(cfg)
            + 12 * H * hd * pairs * cfg["num_hidden_layers"])


def reduction_least_bytes(groups: dict, members: int) -> int:
    """The least bytes of summing `members` vectors into one: each input
    read once and the sum written once, in the gradient's own dtype.
    groups: {dtype name: elements}."""
    return sum((members + 1) * n * _ITEMSIZE[dt] for dt, n in groups.items())


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAK_HBM_BYTES
