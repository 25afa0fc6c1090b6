"""Whisper-style encoder-decoder backbone: training, prefill and decode (the
port of `repro/models/whisper.py`).

The conv audio frontend is a stub, as in the JAX package: the inputs carry
precomputed frame embeddings (B, F, d), what the two conv layers would make
of the mel spectrogram. The encoder is bidirectional over the frames (plus
a learned `pos_embed`); the decoder is causal over the tokens, with a
cross-attention over the encoder states in every layer. Both rotate q and
k by RoPE, as the JAX package's shared `_project_qkv` does.

Attention: training takes autograd through `attention.attention`; in
serving the encoder and every cross-attention go through
`attention.full_attention` (one non-causal flash call over all the frames),
the decoder's prompt through `attention.prefill_attention` and each decode
step's self-attention through `attention.decode_attention`.

Parameters are one flat dict keyed by the JAX pytree's "/"-joined paths:
"embed", "pos_embed", "enc_blocks/...", "enc_norm", "dec_blocks/..." (with
the cross-attention's ln_x, xq, xk, xv, xo), "final_norm", "lm_head",
layer weights stacked as (L, ...). The cache keeps JAX's keys: the self
caches k / v (L, B, S, KV, hd), which `train.serve.generate` pads to the
decode budget, and the cross caches xk / xv (L, B, F, KV, hd), which stay
as the prefill made them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (chunked_softmax_xent, embed_tokens,
                                       init_dense, rms_norm, swiglu,
                                       torch_dtype, unbound_layers)
from repro_torch.models.shardctx import constrain_batch
from repro_torch.models.transformer import (_block_tail, _last_logits,
                                            _positions, _project_qkv,
                                            init_block_params)

ENC, DEC = "enc_blocks/", "dec_blocks/"


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from `generator` on its device, with the JAX
    init's formulas (not its random numbers)."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    zeros = functools.partial(torch.zeros, (d,), dtype=dt,
                              device=generator.device)
    params = {"embed": init_dense((cfg.vocab_size, d), generator,
                                  scale=0.02, dtype=dt),
              "pos_embed": init_dense((cfg.n_audio_frames, d), generator,
                                      scale=0.02, dtype=dt),
              "enc_norm": zeros(), "final_norm": zeros(),
              "lm_head": init_dense((d, cfg.vocab_size), generator,
                                    scale=0.02, dtype=dt)}
    for prefix, n, cross in ((ENC, cfg.encoder_layers, False),
                             (DEC, cfg.n_layers, True)):
        for k, v in init_block_params(cfg, generator, n, cross).items():
            params[prefix + k] = v
    return dict(sorted(params.items()))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           serving: bool = False) -> torch.Tensor:
    """frames: (B, F, d) stubbed conv output -> encoder states (B, F, d).

    As in JAX, x = frames cast to the compute dtype plus `pos_embed` cast
    to the frames' dtype, so fp32 frames run the encoder in fp32."""
    B, F, _ = frames.shape
    x = frames.to(torch_dtype(cfg.compute_dtype)) \
        + params["pos_embed"][None, :F].to(frames.dtype)
    positions = _positions(cfg, B, F, x.device)
    attend = attn.full_attention if serving else functools.partial(
        attn.attention, causal=False)
    for bp in unbound_layers(params, ENC):
        x = constrain_batch(x)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, bp, h, positions)
        x = _block_tail(cfg, x, bp, attend(q, k, v))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, bp: dict, enc: torch.Tensor):
    """A decoder layer's cross-attention keys and values of the encoder
    states: (B, F, KV, hd) each."""
    B, F, _ = enc.shape
    shape = (B, F, cfg.n_kv_heads, cfg.hd)
    return (enc @ bp["xk"]).reshape(shape), (enc @ bp["xv"]).reshape(shape)


def _decoder_layer(cfg: ModelConfig, bp: dict, x, positions, self_attend,
                   xk, xv, cross_attend):
    """Causal self-attention (`self_attend(q, k, v)`), cross-attention of
    ln_x(x) over (xk, xv) (`cross_attend`), then the MLP. Returns (x, k,
    v): the layer's self keys and values for the cache."""
    B, S, _ = x.shape
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, bp, h, positions)
    x = x + self_attend(q, k, v).reshape(B, S, -1) @ bp["wo"]
    h = rms_norm(x, bp["ln_x"], cfg.norm_eps)
    q = (h @ bp["xq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    x = x + cross_attend(q, xk, xv).reshape(B, S, -1) @ bp["xo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"]), k, v


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder over encode(frames): tokens (B, S) -> hidden
    states (B, S, d)."""
    enc = encode(cfg, params, frames)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device)
    causal = functools.partial(attn.attention, causal=True)
    full = functools.partial(attn.attention, causal=False)
    for bp in unbound_layers(params, DEC):
        x = _decoder_layer(cfg, bp, constrain_batch(x), positions, causal,
                           *_cross_kv(cfg, bp, enc), full)[0]
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S), frames (B,F,d)}."""
    h = forward(cfg, params, batch["tokens"], batch["frames"])
    return chunked_softmax_xent(h, params["lm_head"], batch["labels"],
                                chunk=cfg.logits_chunk)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeros in the compute dtype, in the JAX layout: k / v of (L, B,
    max_len, KV, hd), xk / xv of (L, B, n_audio_frames, KV, hd)."""
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    tail = (cfg.n_kv_heads, cfg.hd)
    self_kv = (cfg.n_layers, batch, max_len) + tail
    cross = (cfg.n_layers, batch, cfg.n_audio_frames) + tail
    return {"k": torch.zeros(self_kv, dtype=dt, device=dev),
            "v": torch.zeros(self_kv, dtype=dt, device=dev),
            "xk": torch.zeros(cross, dtype=dt, device=dev),
            "xv": torch.zeros(cross, dtype=dt, device=dev)}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor):
    """Encode the frames, run the decoder over the prompt, fill the self
    and cross caches. Returns (last-token logits (B, V) fp32, cache: k / v
    of the prompt's length S, xk / xv of the frames' F)."""
    enc = encode(cfg, params, frames, serving=True)
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device)
    layers = []
    for bp in unbound_layers(params, DEC):
        xk, xv = _cross_kv(cfg, bp, enc)
        x, k, v = _decoder_layer(cfg, bp, x, positions,
                                 attn.prefill_attention, xk, xv,
                                 attn.full_attention)
        layers.append((k, v, xk, xv))
    cache = {key: torch.stack(leaf) for key, leaf in
             zip(("k", "v", "xk", "xv"), zip(*layers))}
    return _last_logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: (B, 1); pos: their position. Writes each
    layer's k / v at `pos` of its self cache and attends over entries
    [0, pos]; the cross-attention reads every frame of xk / xv. Returns
    (logits (B, V) fp32, cache)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    positions = _positions(cfg, tokens.shape[0], 1, x.device, pos)
    for layer, bp in enumerate(unbound_layers(params, DEC)):
        kc, vc = cache["k"][layer], cache["v"][layer]

        def self_attend(q, k, v, kc=kc, vc=vc):
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
            return attn.decode_attention(q, kc, vc, pos)

        x = _decoder_layer(cfg, bp, x, positions, self_attend,
                           cache["xk"][layer], cache["xv"][layer],
                           attn.full_attention)[0]
    return _last_logits(cfg, params, x), cache
