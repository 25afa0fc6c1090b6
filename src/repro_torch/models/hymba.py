"""Hymba: hybrid-head blocks, training, prefill and decode (the port of
`repro/models/hymba.py`). Attention heads and Mamba (selective SSM) heads
run in parallel on the same normed input; their normed outputs are
averaged into the residual, then a shared SwiGLU MLP follows
(arXiv:2411.13676). Attention is causal within `cfg.hymba_window` keys
(the SSM carries the long-range state), so the decode state is a ring of
`hymba_window` slots per layer plus the conv and SSM states.

Attention: training takes autograd through `attention.attention` (windowed
`chunked_attention` past 1024 keys), as the dense families do; the prefill
goes through `attention.prefill_attention` with the window and each decode
step through `attention.ring_decode_attention` over the ring's filled
slots, both the flash kernels on CUDA tensors. The Mamba scan is plain
PyTorch, as it is jnp (not Pallas) in the JAX package.

Parameters are one flat dict keyed by the JAX pytree's "/"-joined paths,
layer weights stacked as (L, ...); `m_dt_bias`, `m_alog` and `m_d` are
fp32 leaves whatever the parameter dtype. The caches keep JAX's layout:
k / v (L, B, window, KV, hd) with position p at slot p % window, conv
(L, B, 3, d) in the compute dtype, ssm (L, B, d, N) in fp32.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (BLOCKS, chunked_scan,
                                       chunked_softmax_xent, embed_tokens,
                                       init_dense, layer_params, rms_norm,
                                       swiglu, torch_dtype, unbound_layers)
from repro_torch.models.shardctx import constrain_batch
from repro_torch.models.transformer import (_last_logits, _positions,
                                            _project_qkv)


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from `generator` on its device, with the JAX
    init's formulas (not its random numbers)."""
    d, f, L, N = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.ssm_state
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch_dtype(cfg.param_dtype)
    dev = generator.device

    def W(shape, scale=None):
        return init_dense((L,) + shape, generator, scale=scale, dtype=dt)

    def Z(shape, dtype=dt):
        return torch.zeros((L,) + shape, dtype=dtype, device=dev)

    alog = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
    blocks = {
        "ln1": Z((d,)),
        # attention branch
        "wq": W((d, H * hd)), "wk": W((d, KV * hd)),
        "wv": W((d, KV * hd)), "wo": W((H * hd, d)),
        "attn_norm": Z((d,)),
        # mamba branch (d_inner = d)
        "m_in": W((d, 2 * d)),                     # x and gate z
        "m_conv": W((4, d), scale=0.5),
        "m_xbc": W((d, 2 * N + d)),                # B, C, Delta projections
        "m_dt_bias": Z((d,), torch.float32),
        "m_alog": alog.expand(L, d, N).clone(),
        "m_d": torch.ones((L, d), dtype=torch.float32, device=dev),
        "m_out": W((d, d)),
        "mamba_norm": Z((d,)),
        # shared mlp
        "ln2": Z((d,)),
        "w_gate": W((d, f)), "w_up": W((d, f)), "w_down": W((f, d)),
    }
    params = {BLOCKS + k: v for k, v in blocks.items()}
    params["embed"] = init_dense((cfg.vocab_size, d), generator, scale=0.02,
                                 dtype=dt)
    params["final_norm"] = torch.zeros((d,), dtype=dt, device=dev)
    params["lm_head"] = init_dense((d, cfg.vocab_size), generator,
                                   scale=0.02, dtype=dt)
    return dict(sorted(params.items()))


# ----------------------------------------------------------------------------
# the Mamba branch
# ----------------------------------------------------------------------------

def _ssm_chunk(A: torch.Tensor, state: torch.Tensor, xs):
    """One chunk of the selective scan, time-major: xs = (x (T,B,d),
    B (T,B,N), C (T,B,N), delta (T,B,d)), state (B,d,N) fp32.

    Each step is JAX's: dA = exp(delta_t A), dBx = delta_t B_t x_t,
    state = state * dA + dBx, y_t = state . C_t. The terms that carry no
    state (dA, dBx for every step, and the C contraction of the stacked
    states) are formed for the whole chunk at once, so the time loop
    launches only the state update."""
    x, Bm, Cm, dl = xs
    dA = torch.exp(dl[..., None] * A)                        # (T,B,d,N)
    dBx = dl[..., None] * Bm[:, :, None, :] * x[..., None]
    states = []
    for dA_t, dBx_t in zip(dA.unbind(0), dBx.unbind(0)):
        state = state * dA_t + dBx_t
        states.append(state)
    ys = torch.einsum("tbdn,tbn->tbd", torch.stack(states), Cm)
    return state, ys


def _mamba_scan(cfg: ModelConfig, bp: dict, h: torch.Tensor,
                conv_state=None, ssm_state=None):
    """Selective SSM over h (B, S, d). Returns (out (B,S,d) in h's dtype,
    conv_state (B,3,d) in h's dtype, ssm_state (B,d,N) fp32); a state left
    None starts at zero (the depthwise conv's left padding, the SSM's)."""
    B, S, d = h.shape
    N = cfg.ssm_state
    x, z = (h @ bp["m_in"]).chunk(2, dim=-1)
    # depthwise causal conv, kernel 4, in fp32
    k = bp["m_conv"].float()                                # (4, d)
    xp = x.float()
    if conv_state is None:
        conv_in = F.pad(xp, (0, 0, 3, 0))
    else:
        conv_in = torch.cat([conv_state.float(), xp], 1)
    xc = conv_in[:, 0:S] * k[0]
    for i in range(1, 4):
        xc = xc + conv_in[:, i:i + S] * k[i]
    new_conv_state = conv_in[:, -3:].to(h.dtype)
    xc = F.silu(xc)

    bcd = xc.to(h.dtype) @ bp["m_xbc"]
    Bm = bcd[..., :N].float()                               # (B,S,N)
    Cm = bcd[..., N:2 * N].float()
    dt_raw = bcd[..., 2 * N:].float()                       # (B,S,d)
    delta = F.softplus(dt_raw + bp["m_dt_bias"])
    A = -torch.exp(bp["m_alog"])                            # (d, N)
    if ssm_state is None:
        ssm_state = torch.zeros((B, d, N), dtype=torch.float32,
                                device=h.device)
    ssm_state, ys = chunked_scan(
        functools.partial(_ssm_chunk, A), ssm_state,
        [a.transpose(0, 1) for a in (xc, Bm, Cm, delta)], cfg.ssm_chunk)
    y = ys.transpose(0, 1) + xc * bp["m_d"]
    y = y * F.silu(z.float())
    out = y.to(h.dtype) @ bp["m_out"]
    return out, new_conv_state, ssm_state


# ----------------------------------------------------------------------------
# one layer
# ----------------------------------------------------------------------------

def _layer(cfg: ModelConfig, bp: dict, x, positions, attend,
           conv_state=None, ssm_state=None):
    """Attention and Mamba in parallel on ln1(x), each output normed, their
    mean added to x, then the SwiGLU MLP. `attend(q, k, v)` is the
    attention of this mode. Returns (x, k, v, conv_state, ssm_state)."""
    B, S, _ = x.shape
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, bp, h, positions)
    a_out = attend(q, k, v).reshape(B, S, -1) @ bp["wo"]
    a_out = rms_norm(a_out, bp["attn_norm"], cfg.norm_eps)
    m_out, conv_state, ssm_state = _mamba_scan(cfg, bp, h, conv_state,
                                               ssm_state)
    m_out = rms_norm(m_out, bp["mamba_norm"], cfg.norm_eps)
    x = x + 0.5 * (a_out + m_out)
    h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + swiglu(h2, bp["w_gate"], bp["w_up"], bp["w_down"])
    return x, k, v, conv_state, ssm_state


# ----------------------------------------------------------------------------
# forward (training)
# ----------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens: (B, S) -> hidden states (B, S, d)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device)
    attend = functools.partial(attn.attention, causal=True,
                               window=cfg.hymba_window)
    for bp in unbound_layers(params):
        x = _layer(cfg, bp, constrain_batch(x), positions, attend)[0]
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S)}."""
    h = forward(cfg, params, batch["tokens"])
    return chunked_softmax_xent(h, params["lm_head"], batch["labels"],
                                chunk=cfg.logits_chunk)


# ----------------------------------------------------------------------------
# serving: rings of `hymba_window` slots, conv and SSM states
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeros in the JAX layout; max_len is not used (the state does not
    grow with the sequence)."""
    L, d, N = cfg.n_layers, cfg.d_model, cfg.ssm_state
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    ring = (L, batch, cfg.hymba_window, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(ring, dtype=dt, device=dev),
            "v": torch.zeros(ring, dtype=dt, device=dev),
            "conv": torch.zeros((L, batch, 3, d), dtype=dt, device=dev),
            "ssm": torch.zeros((L, batch, d, N), dtype=torch.float32,
                               device=dev)}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-prompt forward that fills the caches: each layer's last
    min(S, window) keys scattered into their ring slots (position %
    window), the conv input's last 3 steps and the final SSM state.
    Returns (last-token logits (B, V) fp32, cache)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device)
    cache = init_cache(cfg, B, S, x.device)
    w = cfg.hymba_window
    keep = min(S, w)
    slots = torch.arange(S - keep, S, device=x.device) % w
    attend = functools.partial(attn.prefill_attention, window=w)
    for layer in range(cfg.n_layers):
        bp = layer_params(params, layer)
        x, k, v, conv, ssm = _layer(cfg, bp, x, positions, attend)
        cache["k"][layer].index_copy_(1, slots, k[:, S - keep:])
        cache["v"][layer].index_copy_(1, slots, v[:, S - keep:])
        cache["conv"][layer] = conv
        cache["ssm"][layer] = ssm
    return _last_logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: (B, 1); pos: their position. Writes each
    layer's k / v at ring slot pos % window and attends over the ring's
    min(pos + 1, window) filled slots (JAX's mask over the whole ring,
    positions (pos - window, pos]); the conv and SSM states advance one
    step in place. Returns (logits (B, V) fp32, cache)."""
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    positions = _positions(cfg, tokens.shape[0], 1, x.device, pos)
    w = cache["k"].shape[2]
    for layer in range(cfg.n_layers):
        bp = layer_params(params, layer)
        kc, vc = cache["k"][layer], cache["v"][layer]

        def attend(q, k, v, kc=kc, vc=vc):
            kc[:, pos % w] = k[:, 0]
            vc[:, pos % w] = v[:, 0]
            return attn.ring_decode_attention(q, kc, vc, min(pos + 1, w))

        x, _, _, conv, ssm = _layer(cfg, bp, x, positions, attend,
                                    cache["conv"][layer], cache["ssm"][layer])
        cache["conv"][layer] = conv
        cache["ssm"][layer] = ssm
    return _last_logits(cfg, params, x), cache
