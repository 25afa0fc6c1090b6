"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2,
)

SMOKE = FULL.replace(
    name="phi35-moe-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=4, top_k=2,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32)
