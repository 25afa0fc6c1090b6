"""Decoder-only transformer: training, prefill and decode (the port of
`repro/models/transformer.py` for qwen3, internlm2, minicpm, gemma3,
qwen2-vl and the MoE decoders phi3.5-moe and arctic-480b, whose FFN is
`moe.moe_ffn` in every layer: `ffn_apply` keys on `cfg.n_experts`, as in
JAX). gemma3's 5:1 local:global attention is a per-layer flag
(`layer_is_global`): a local layer attends within `cfg.local_window` keys,
and in serving keeps a rolling cache of `local_window` slots (slot =
position % window) where a global layer keeps the full sequence. qwen2-vl
(family "vlm", `cfg.mrope`) rotates q and k by M-RoPE over (B, S, 3)
(t, h, w) positions, arange stacked 3x for text, and its `forward` /
`loss_fn` take an optional `prefix_embeds` (B, P, d) patch prefix placed
before the token embeddings, whose label positions are masked (-100).

Parameters are one flat dict keyed by the JAX pytree's "/"-joined paths
("embed", "blocks/wq", "final_norm", ...) in the pytree's leaf order (sorted
paths), with layer weights stacked as (L, ...), so weights convert one to
one. The layer loop is a Python loop over the unbound stacks; training
runs each block under `cfg.remat` (`remat_block`: "none", "full" or
"dots"), as JAX wraps `dense_block` in `jax.checkpoint`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.common import (BLOCKS, apply_mrope, apply_rope,
                                       chunked_softmax_xent, embed_tokens,
                                       init_dense, layer_params, rms_norm,
                                       swiglu, torch_dtype, unbound_layers)
from repro_torch.models.shardctx import constrain_batch


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    missing = []
    if cfg.family not in ("dense", "vlm", "moe"):
        missing.append(f"family {cfg.family!r}")
    if cfg.encoder_layers:
        missing.append("cross-attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            "runs the dense, vlm and moe paths)")


def layer_is_global(cfg: ModelConfig) -> np.ndarray:
    """(n_layers,) bool: every layer is global unless cfg.global_every > 0,
    then layer l is global when (l + 1) % global_every == 0."""
    if cfg.global_every <= 0:
        return np.ones(cfg.n_layers, bool)
    return np.array([(l + 1) % cfg.global_every == 0
                     for l in range(cfg.n_layers)])


def _layer_window(cfg: ModelConfig, is_global: bool) -> int:
    return 0 if is_global else cfg.local_window


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def init_block_params(cfg: ModelConfig, generator: torch.Generator,
                      n_layers: int, cross_attn: bool = False,
                      dense_ffn: bool = True) -> dict:
    """The stacked (n_layers, ...) weights of a block; with `cross_attn`
    also its cross-attention's (whisper's decoder: ln_x, xq, xk, xv,
    xo); without `dense_ffn` no w_gate, w_up, w_down (an MoE block, whose
    FFN leaves `moe.init_moe_params` draws)."""
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
              "wv": W((d, KV * hd)), "wo": W((H * hd, d)), "ln2": Z((d,))}
    if dense_ffn:
        params.update(w_gate=W((d, f)), w_up=W((d, f)), w_down=W((f, d)))
    if cfg.qk_norm:
        params["q_norm"] = Z((hd,))
        params["k_norm"] = Z((hd,))
    if cross_attn:
        params.update(ln_x=Z((d,)), xq=W((d, H * hd)), xk=W((d, KV * hd)),
                      xv=W((d, KV * hd)), xo=W((H * hd, d)))
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from `generator` on its device, with the
    JAX init's formulas (not its random numbers)."""
    check_supported(cfg)
    dt = torch_dtype(cfg.param_dtype)
    blocks = init_block_params(cfg, generator, cfg.n_layers,
                               dense_ffn=cfg.n_experts == 0)
    if cfg.n_experts > 0:
        blocks.update(moe.init_moe_params(cfg, generator, cfg.n_layers))
    params = {BLOCKS + k: v for k, v in blocks.items()}
    params["embed"] = init_dense((cfg.vocab_size, cfg.d_model), generator,
                                 scale=0.02, dtype=dt)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                       device=generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense((cfg.d_model, cfg.vocab_size),
                                       generator, scale=0.02, dtype=dt)
    return dict(sorted(params.items()))


def ffn_apply(cfg: ModelConfig, h: torch.Tensor, bp: dict) -> torch.Tensor:
    """Dense SwiGLU or MoE FFN, keyed on the config."""
    if cfg.n_experts > 0:
        return moe.moe_ffn(cfg, h, bp)
    return swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"])


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
    rope = apply_mrope if cfg.mrope else apply_rope
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _positions(cfg: ModelConfig, B: int, S: int, device, start: int = 0):
    """Positions start .. start + S - 1 of every row: (B, S), or for
    M-RoPE (B, S, 3) with equal (t, h, w) ids (text tokens)."""
    pos = torch.arange(start, start + S, device=device)[None].expand(B, S)
    return torch.stack([pos] * 3, -1) if cfg.mrope else pos


def _block_tail(cfg: ModelConfig, x, bp, out):
    """The layer after attention: output projection, residual, FFN."""
    B, S, _ = x.shape
    x = x + out.reshape(B, S, -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + ffn_apply(cfg, h, bp)


def dense_block(cfg: ModelConfig, x, bp, positions, is_global: bool = True,
                causal: bool = True):
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, bp, h, positions)
    out = attn.attention(q, k, v, causal=causal,
                         window=_layer_window(cfg, is_global))
    return _block_tail(cfg, x, bp, out)


# the matrix products that remat="dots" saves: what `@`, `torch.einsum`
# and `torch.bmm` dispatch to, as JAX's checkpoint_dots saves every
# dot_general (attention's score and value products included)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(cfg: ModelConfig, block):
    """`block` under cfg.remat, as JAX wraps dense_block: "none" as it is;
    "full" checkpointed (only its inputs kept, the rest recomputed in the
    backward); "dots" selectively checkpointed (the outputs of its matrix
    products kept, the rest recomputed). Autograd's graph is the same in
    all three, so the gradients are too, to the bit."""
    if cfg.remat == "none":
        return block
    if cfg.remat == "full":
        return functools.partial(checkpoint, block, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, block, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r} (none, full "
                     "or dots)")


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions=None, prefix_embeds=None) -> torch.Tensor:
    """tokens: (B, S) -> hidden states (B, P + S, d), P the length of the
    optional prefix_embeds (B, P, d)."""
    check_supported(cfg)
    block = remat_block(cfg, functools.partial(dense_block, cfg))
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(cfg, B, S, x.device)
    for bp, is_global in zip(unbound_layers(params), layer_is_global(cfg)):
        x = block(constrain_batch(x), bp, positions, bool(is_global))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S), [positions], [prefix_embeds]}."""
    prefix = batch.get("prefix_embeds")
    h = forward(cfg, params, batch["tokens"], batch.get("positions"), prefix)
    labels = batch["labels"]
    if prefix is not None:
        pad = labels.new_full((labels.shape[0], prefix.shape[1]), -100)
        labels = torch.cat([pad, labels], dim=1)
    return chunked_softmax_xent(h, unembed_matrix(cfg, params), labels,
                                chunk=cfg.logits_chunk)


# ----------------------------------------------------------------------------
# serving: full caches for global layers, rolling for local ones
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeros in the compute dtype, in the JAX layout: k_glob / v_glob of
    (max(n_glob, 1), B, max_len, KV, hd) for the global layers, and, when
    there are local layers, k_loc / v_loc of (n_loc, B, local_window, KV,
    hd), the rings."""
    check_supported(cfg)
    is_glob = layer_is_global(cfg)
    n_glob, n_loc = int(is_glob.sum()), int((~is_glob).sum())
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    tail = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k_glob": torch.zeros((max(n_glob, 1),) + tail, dtype=dt,
                                   device=dev),
             "v_glob": torch.zeros((max(n_glob, 1),) + tail, dtype=dt,
                                   device=dev)}
    if n_loc:
        ring = (n_loc, batch, cfg.local_window) + tail[2:]
        cache["k_loc"] = torch.zeros(ring, dtype=dt, device=dev)
        cache["v_loc"] = torch.zeros(ring, dtype=dt, device=dev)
    return cache


def _cache_index_maps(cfg: ModelConfig):
    """(is_global, gi, li) per layer: gi is a global layer's index in the
    k_glob / v_glob stack, li a local layer's in k_loc / v_loc (0 for the
    other kind)."""
    is_glob = layer_is_global(cfg)
    gi, li, g, l = [], [], 0, 0
    for flag in is_glob:
        gi.append(g if flag else 0)
        li.append(l if not flag else 0)
        g += int(flag)
        l += int(not flag)
    return is_glob, gi, li


def _last_logits(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    """fp32 logits (B, V) of the last position of x (B, S, d)."""
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return x.float() @ unembed_matrix(cfg, params).float()


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: (B, 1); pos: the position of these tokens.

    Writes each layer's k/v in place (the counterpart of JAX's
    dynamic_update_slice): a global layer at `pos` of its full cache,
    attending over entries [0, pos]; a local layer at slot pos % window of
    its ring, attending over the ring's min(pos + 1, window) filled slots.
    Returns (logits (B, V) fp32, cache)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    positions = _positions(cfg, tokens.shape[0], 1, x.device, pos)
    for layer, (is_global, gidx, lidx) in enumerate(
            zip(*_cache_index_maps(cfg))):
        x = constrain_batch(x)
        bp = layer_params(params, layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, bp, h, positions)
        if is_global:
            kc, vc = cache["k_glob"][gidx], cache["v_glob"][gidx]
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
            out = attn.decode_attention(q, kc, vc, pos)
        else:
            kc, vc = cache["k_loc"][lidx], cache["v_loc"][lidx]
            w = kc.shape[1]
            kc[:, pos % w] = k[:, 0]
            vc[:, pos % w] = v[:, 0]
            out = attn.ring_decode_attention(q, kc, vc, min(pos + 1, w))
        x = _block_tail(cfg, x, bp, out)
    return _last_logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-prompt forward that also fills the KV caches: a global layer's
    whole prompt, a local layer's last min(S, window) keys scattered into
    their ring slots (position % window).

    Returns (last-token logits (B, V) fp32, cache: global caches of length
    S, rings of `local_window` slots)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device)
    cache = init_cache(cfg, B, S, x.device)
    if "k_loc" in cache:
        w = cfg.local_window
        keep = min(S, w)
        slots = torch.arange(S - keep, S, device=x.device) % w
    for layer, (is_global, gidx, lidx) in enumerate(
            zip(*_cache_index_maps(cfg))):
        x = constrain_batch(x)
        bp = layer_params(params, layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, bp, h, positions)
        if is_global:
            cache["k_glob"][gidx] = k
            cache["v_glob"][gidx] = v
        else:
            cache["k_loc"][lidx].index_copy_(1, slots, k[:, S - keep:])
            cache["v_loc"][lidx].index_copy_(1, slots, v[:, S - keep:])
        out = attn.prefill_attention(q, k, v,
                                     window=_layer_window(cfg, is_global))
        x = _block_tail(cfg, x, bp, out)
    return _last_logits(cfg, params, x), cache
