"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; parallel attention + mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", family="hymba", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
    ssm_state=16, hymba_window=1024,
)

SMOKE = FULL.replace(
    name="hymba-smoke", n_layers=2, d_model=60, n_heads=5, n_kv_heads=5,
    d_ff=128, vocab_size=512, ssm_state=4, hymba_window=16,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32)
