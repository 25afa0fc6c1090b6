"""rwkv6-7b [ssm]: 32L d=4096 attention-free, d_ff=14336 vocab=65536.
Finch: data-dependent decay [arXiv:2404.05892]. head_dim (ssm_state) = 64.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b", family="rwkv6", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536,
    ssm_state=64,
)

SMOKE = FULL.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=128, vocab_size=512, ssm_state=8, param_dtype="float32",
    compute_dtype="float32", logits_chunk=32)
