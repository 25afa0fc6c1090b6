"""The benchmark's cells cut to a size that a CPU test holds: every width
small, the same layer kinds, traffic and code paths."""
from bench.harness import spec as spec_mod

SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 96,
         "vocab_size": 512}
CELLS = ("internlm2-train-degraded", "internlm2-allreduce-degraded",
         "phi35moe-train-healthy", "internlm2-allreduce-healthy")
TRAIN = tuple(c for c in CELLS if "-train-" in c)
ALLREDUCE = tuple(c for c in CELLS if "-allreduce-" in c)


def small_spec(cell: str, dtype: str = "float32", limits: bool = True):
    """`cell`'s spec at small widths in `dtype`, with the program's
    configuration cut to match; `limits` False drops the cell's limits."""
    spec = spec_mod.load(cell)
    cfg = spec.config
    cfg.update(SMALL)
    port = {**cfg["port"]["set"], "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "d_ff": 96, "vocab_size": 512, "param_dtype": dtype,
            "compute_dtype": dtype, "logits_chunk": 16}
    if cfg.get("num_local_experts"):
        cfg.update(num_local_experts=4, num_attention_heads=8)
        port.update(n_experts=4, n_heads=8)
    cfg["param_dtype"] = cfg["compute_dtype"] = dtype
    cfg["port"]["set"] = port
    if spec.traffic["driver"] == "train":
        spec.traffic.update(seq_len=32, batch_pool=8, traced_steps=1)
    else:
        spec.traffic.update(sample_among=4, traced_calls=2)
    if not limits:
        spec.limits = None
    return spec
