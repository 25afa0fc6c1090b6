"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].
bf16 Adam moments and FSDP keep the JAX package's optimizer state inside
a TPU's memory; the port copies the fields as they are."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_dense_ff=4864,
    moment_dtype="bfloat16", fsdp=True,
)

SMOKE = FULL.replace(
    name="arctic-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab_size=512, n_experts=8, top_k=2, moe_dense_ff=96,
    param_dtype="float32", compute_dtype="float32", logits_chunk=32,
    moment_dtype="float32")
