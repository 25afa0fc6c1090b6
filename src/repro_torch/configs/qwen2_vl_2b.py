"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE + dynamic-resolution patch frontend STUB [arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
    mrope=True, n_patch_tokens=1024, tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="qwen2-vl-smoke", n_layers=2, d_model=48, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab_size=512, n_patch_tokens=8,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32)
