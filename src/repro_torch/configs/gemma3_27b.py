"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5:1 local:global attention, 128k context [hf:google/gemma-3 family]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, d_ff=21504, vocab_size=262144,
    head_dim=128, qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    global_every=6, local_window=1024,
)

SMOKE = FULL.replace(
    name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, local_window=16,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32)
