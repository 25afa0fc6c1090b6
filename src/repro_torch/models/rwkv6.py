"""RWKV-6 "Finch": attention-free RNN with data-dependent decay, forward
and serving (the port of `repro/models/rwkv6.py`; training waits for a
backward of the wkv kernel).

Per layer: time-mix (the wkv recurrence over a per-head (hd x hd) state
with data-dependent decay w_t, driven by r/k/v/g projections with
token-shift) and channel-mix (token-shifted squared-ReLU MLP). The serving
state is O(1) in sequence length: (L, B, H, hd, hd) plus shift states.

Every wkv recurrence - the whole prompt in prefill and forward, one token
per decode step chained through the layer's state - goes through
`kernels.wkv.ops.wkv`: the Hopper kernel for CUDA tensors, its plain
version for CPU tensors. Parameters are one flat dict keyed by the JAX
pytree's "/"-joined paths, layer weights stacked as (L, ...); `w_base` and
`bonus` are fp32 leaves whatever the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.wkv import wkv
from repro_torch.models.common import (BLOCKS, embed_tokens, init_dense,
                                       layer_params, rms_norm, torch_dtype)


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.ssm_state or 64
    return cfg.d_model // hd, hd


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from `generator` on its device, with the JAX
    init's formulas (not its random numbers)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, hd = _dims(cfg)
    dt = torch_dtype(cfg.param_dtype)
    dev = generator.device

    def W(shape, scale=None):
        return init_dense((L,) + shape, generator, scale=scale, dtype=dt)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    blocks = {
        "ln1": full((L, d), 0.0),
        "mix_rkvwg": full((L, 5, d), 0.5),              # token-shift lerp
        "wr": W((d, d)), "wk": W((d, d)), "wv": W((d, d)),
        "wg": W((d, d)), "wo": W((d, d)),
        # data-dependent decay: low-rank w = base + tanh(x A) B
        "w_base": full((L, H, hd), -6.0, torch.float32),
        "w_lora_a": W((d, 64)),
        "w_lora_b": W((64, d), scale=0.01),
        "bonus": full((L, H, hd), 0.0, torch.float32),  # "u" first-token boost
        "ln_x": full((L, d), 0.0),                      # per-head group norm
        "ln2": full((L, d), 0.0),
        "ck": W((d, f)), "cv": W((f, d)), "cr": W((d, d)),
        "mix_c": full((L, 2, d), 0.5),
    }
    params = {BLOCKS + k: v for k, v in blocks.items()}
    params["embed"] = init_dense((cfg.vocab_size, d), generator, scale=0.02,
                                 dtype=dt)
    params["final_norm"] = full((d,), 0.0)
    params["lm_head"] = init_dense((d, cfg.vocab_size), generator,
                                   scale=0.02, dtype=dt)
    return dict(sorted(params.items()))


# ----------------------------------------------------------------------------
# time mix and channel mix
# ----------------------------------------------------------------------------

def _time_mix(cfg, bp, h, h_prev, state0=None):
    """The time-mix branch over (B, S, d): h the normed input, h_prev the
    token-shifted one (both fp32). Returns (out (B, S, d) fp32, final wkv
    state (B, H, hd, hd))."""
    H, hd = _dims(cfg)
    B, S, d = h.shape
    mix = bp["mix_rkvwg"].float()                        # (5, d)
    sx = [h_prev + mix[i] * (h - h_prev) for i in range(5)]
    r = (sx[0] @ bp["wr"].float()).reshape(B, S, H, hd)
    k = (sx[1] @ bp["wk"].float()).reshape(B, S, H, hd)
    v = (sx[2] @ bp["wv"].float()).reshape(B, S, H, hd)
    g = F.silu(sx[4] @ bp["wg"].float())
    # data-dependent decay (Finch): w_t in (0,1), per channel
    w_dd = torch.tanh(sx[3] @ bp["w_lora_a"].float()) \
        @ bp["w_lora_b"].float()
    w = torch.exp(-torch.exp(bp["w_base"].reshape(1, 1, H, hd)
                             + w_dd.reshape(B, S, H, hd)))
    u = bp["bonus"].float().reshape(H, hd)
    out, state = wkv(r, k, v, w, u, state0)
    out = rms_norm(out.reshape(B, S, H * hd), bp["ln_x"], cfg.norm_eps)
    return (out * g) @ bp["wo"].float(), state


def _channel_mix(cfg, bp, h2, h2_prev):
    mixc = bp["mix_c"].float()
    xk = h2_prev + mixc[0] * (h2 - h2_prev)
    xr = h2_prev + mixc[1] * (h2 - h2_prev)
    kk = torch.square(torch.relu(xk @ bp["ck"].float()))
    rr = torch.sigmoid(xr @ bp["cr"].float())
    return rr * (kk @ bp["cv"].float())


def _shift(h):
    """Token shift: position t sees t-1, the first position zeros."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _layer_parallel(cfg, bp, x):
    """One rwkv6 layer over (B, S, d), sequence-parallel: every projection
    is one matmul over the whole sequence, token shift is a shifted copy,
    and the recurrence is one wkv call. Returns (x_out, (tshift, cshift,
    wkv_state))."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps).float()
    out, state = _time_mix(cfg, bp, h, _shift(h))
    x = x + out.to(x.dtype)
    tshift = h[:, -1].to(x.dtype)
    h2 = rms_norm(x, bp["ln2"], cfg.norm_eps).float()
    x = x + _channel_mix(cfg, bp, h2, _shift(h2)).to(x.dtype)
    cshift = h2[:, -1].to(x.dtype)
    return x, (tshift, cshift, state)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens: (B, S) -> hidden states (B, S, d)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    for layer in range(cfg.n_layers):
        x, _ = _layer_parallel(cfg, layer_params(params, layer), x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------------------
# serving: O(1) state
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """wkv (L, B, H, hd, hd) fp32; tshift/cshift (L, B, d) in the compute
    dtype. max_len is unused: the state does not grow."""
    H, hd = _dims(cfg)
    L, d = cfg.n_layers, cfg.d_model
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    return {"wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                               device=dev),
            "tshift": torch.zeros((L, batch, d), dtype=dt, device=dev),
            "cshift": torch.zeros((L, batch, d), dtype=dt, device=dev)}


def _logits(params: dict, x) -> torch.Tensor:
    return x.float() @ params["lm_head"].float()


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) -> (logits (B, V) fp32, cache). Each layer runs the
    wkv op on its one token with state0 = the layer's cached state; the
    cache is updated in place. `pos` is unused (the state carries it)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    for layer in range(cfg.n_layers):
        bp = layer_params(params, layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)          # (B, 1, d)
        tsh = cache["tshift"][layer][:, None].float()
        out, state = _time_mix(cfg, bp, h.float(), tsh, cache["wkv"][layer])
        x = x + out.to(x.dtype)
        h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        csh = cache["cshift"][layer][:, None].float()
        x = x + _channel_mix(cfg, bp, h2.float(), csh).to(x.dtype)
        cache["wkv"][layer] = state
        cache["tshift"][layer] = h[:, 0]
        cache["cshift"][layer] = h2[:, 0]
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return _logits(params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Parallel prefill: sequence-parallel layers, recurrent state out.
    Returns (last-token logits (B, V) fp32, cache)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    cache = init_cache(cfg, x.shape[0], x.shape[1], x.device)
    for layer in range(cfg.n_layers):
        x, (tsh, csh, state) = _layer_parallel(
            cfg, layer_params(params, layer), x)
        cache["wkv"][layer] = state
        cache["tshift"][layer] = tsh
        cache["cshift"][layer] = csh
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(params, x), cache
