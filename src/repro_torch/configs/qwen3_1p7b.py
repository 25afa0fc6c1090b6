"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, param_dtype="float32",
    compute_dtype="float32", logits_chunk=32)
