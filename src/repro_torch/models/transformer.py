"""Dense decoder-only transformer: training, prefill and decode (the port of
`repro/models/transformer.py` for qwen3-style dense models, whose layers
are all global).

Parameters are one flat dict keyed by the JAX pytree's "/"-joined paths
("embed", "blocks/wq", "final_norm", ...) in the pytree's leaf order (sorted
paths), with layer weights stacked as (L, ...), so weights convert one to
one. The layer loop is a Python loop over the unbound stacks.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (BLOCKS, apply_rope,
                                       chunked_softmax_xent, embed_tokens,
                                       init_dense, layer_params, rms_norm,
                                       swiglu, torch_dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.n_experts > 0:
        missing.append("MoE")
    if cfg.mrope:
        missing.append("M-RoPE")
    if cfg.global_every > 0:
        missing.append("local:global attention")
    if cfg.encoder_layers:
        missing.append("cross-attention")
    if cfg.remat != "none":
        missing.append(f"remat={cfg.remat!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            "runs the dense path)")


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def init_block_params(cfg: ModelConfig, generator: torch.Generator,
                      n_layers: int) -> dict:
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    d, f = cfg.d_model, cfg.d_ff
    L = n_layers
    dt = torch_dtype(cfg.param_dtype)
    dev = generator.device

    def W(shape):
        return init_dense((L,) + shape, generator, dtype=dt)

    def Z(shape):
        return torch.zeros((L,) + shape, dtype=dt, device=dev)

    params = {"ln1": Z((d,)), "wq": W((d, H * hd)), "wk": W((d, KV * hd)),
              "wv": W((d, KV * hd)), "wo": W((H * hd, d)), "ln2": Z((d,)),
              "w_gate": W((d, f)), "w_up": W((d, f)), "w_down": W((f, d))}
    if cfg.qk_norm:
        params["q_norm"] = Z((hd,))
        params["k_norm"] = Z((hd,))
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from `generator` on its device, with the
    JAX init's formulas (not its random numbers)."""
    check_supported(cfg)
    dt = torch_dtype(cfg.param_dtype)
    blocks = init_block_params(cfg, generator, cfg.n_layers)
    params = {BLOCKS + k: v for k, v in blocks.items()}
    params["embed"] = init_dense((cfg.vocab_size, cfg.d_model), generator,
                                 scale=0.02, dtype=dt)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                       device=generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense((cfg.d_model, cfg.vocab_size),
                                       generator, scale=0.02, dtype=dt)
    return dict(sorted(params.items()))


def unembed_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ----------------------------------------------------------------------------
# forward (training)
# ----------------------------------------------------------------------------

def _project_qkv(cfg, bp, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ bp["wq"]).reshape(B, S, H, hd)
    k = (x @ bp["wk"]).reshape(B, S, KV, hd)
    v = (x @ bp["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, bp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, bp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_tail(cfg: ModelConfig, x, bp, out):
    """The layer after attention: output projection, residual, MLP."""
    B, S, _ = x.shape
    x = x + out.reshape(B, S, -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"])


def dense_block(cfg: ModelConfig, x, bp, positions, causal: bool = True):
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, bp, h, positions)
    return _block_tail(cfg, x, bp, attn.attention(q, k, v, causal=causal))


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions=None) -> torch.Tensor:
    """tokens: (B, S) -> hidden states (B, S, d)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    # unbind once: autograd then stacks each weight's layer grads in one op
    layers = {k[len(BLOCKS):]: v.unbind(0) for k, v in params.items()
              if k.startswith(BLOCKS)}
    for layer in range(cfg.n_layers):
        bp = {k: v[layer] for k, v in layers.items()}
        x = dense_block(cfg, x, bp, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S), [positions]}."""
    h = forward(cfg, params, batch["tokens"], batch.get("positions"))
    return chunked_softmax_xent(h, unembed_matrix(cfg, params),
                                batch["labels"], chunk=cfg.logits_chunk)


# ----------------------------------------------------------------------------
# serving: a full-length KV cache per (global) layer
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """k_glob / v_glob: (L, B, max_len, KV, hd) zeros in the compute dtype."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    return {"k_glob": torch.zeros(shape, dtype=dt, device=dev),
            "v_glob": torch.zeros(shape, dtype=dt, device=dev)}


def _last_logits(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    """fp32 logits (B, V) of the last position of x (B, S, d)."""
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return x.float() @ unembed_matrix(cfg, params).float()


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: (B, 1); pos: the position of these tokens.

    Writes each layer's k/v at `pos` of the cache in place (the counterpart
    of JAX's dynamic_update_slice) and attends over entries [0, pos].
    Returns (logits (B, V) fp32, cache)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    positions = torch.full(tokens.shape, pos, dtype=torch.int64,
                           device=x.device)
    kc, vc = cache["k_glob"], cache["v_glob"]
    for layer in range(cfg.n_layers):
        bp = layer_params(params, layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, bp, h, positions)
        kc[layer, :, pos] = k[:, 0]
        vc[layer, :, pos] = v[:, 0]
        out = attn.decode_attention(q, kc[layer], vc[layer], pos)
        x = _block_tail(cfg, x, bp, out)
    return _last_logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-prompt forward that also fills the KV cache.

    Returns (last-token logits (B, V) fp32, cache of length S)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, S, x.device)
    for layer in range(cfg.n_layers):
        bp = layer_params(params, layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, bp, h, positions)
        cache["k_glob"][layer] = k
        cache["v_glob"][layer] = v
        x = _block_tail(cfg, x, bp, attn.prefill_attention(q, k, v))
    return _last_logits(cfg, params, x), cache
