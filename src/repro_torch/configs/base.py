"""ModelConfig: one schema covering all 10 assigned architectures.

A copy of `repro/configs/base.py`, field for field, so a configuration
means the same in both packages."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv6 | hymba | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                   # qwen3-style
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False

    # gemma3-style interleaved local:global attention
    global_every: int = 0                   # 0 = all global; N = every Nth
    local_window: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_dense_ff: int = 0                   # arctic dense-residual FFN width
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0                      # rwkv6 head dim / hymba state
    hymba_window: int = 1024                # sliding window for hybrid attn
    ssm_chunk: int = 256                    # remat chunk for time scans
    use_wkv_kernel: bool = False            # rwkv serving via the wkv kernel

    # whisper (enc-dec)
    encoder_layers: int = 0
    n_audio_frames: int = 1500

    # vlm
    mrope: bool = False
    n_patch_tokens: int = 1024              # stubbed image-patch prefix

    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # runtime / distribution knobs (overridable per run)
    remat: str = "none"                     # none | full | dots
    fsdp: bool = True                       # shard params over data axis too
    moment_dtype: str = "float32"           # AdamW moment dtype (HBM knob)
    logits_chunk: int = 256                 # seq chunk for vocab xent
    scan_layers: bool = True                # JAX only: lax.scan over layers

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.family == "whisper"

    @property
    def approx_params(self) -> int:
        """Rough parameter count for roofline MODEL_FLOPS."""
        d, L = self.d_model, self.n_layers
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "rwkv6":
            attn = 5 * d * d + d * d        # r,k,v,g,w projections + out
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.n_experts \
                + 3 * d * self.moe_dense_ff
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "hymba":
            attn += 3 * d * d + d * self.ssm_state * 2  # mamba branch
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + ffn) if self.is_encdec else 0
        cross = self.encoder_layers and L * (attn // 2)
        return L * (attn + ffn) + emb + enc + (cross or 0)

    @property
    def active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.approx_params
        d, L = self.d_model, self.n_layers
        full = self.approx_params
        inactive = L * 3 * d * self.d_ff * (self.n_experts - self.top_k)
        return full - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
