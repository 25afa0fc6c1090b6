"""minicpm-2b [dense]: 40L d=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.
WSD schedule, llama-like arch [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753,
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="minicpm-smoke", n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
    d_ff=144, vocab_size=512, param_dtype="float32",
    compute_dtype="float32", logits_chunk=32)
