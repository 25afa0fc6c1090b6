"""whisper-base [audio]: 6L (x2: enc+dec) d=512 8H d_ff=2048 vocab=51865,
enc-dec with conv frontend STUB (precomputed 1500-frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="whisper", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    encoder_layers=6, n_audio_frames=1500,
)

SMOKE = FULL.replace(
    name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, encoder_layers=2, n_audio_frames=24,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32)
