"""Hand-written Hopper kernels of the port, one package each
(`kernel.py` binds the CUDA source, `ref.py` is its plain PyTorch version,
`ops.py` dispatches on the tensor's device).

Each `kernel.py` keeps a `launches` count per entry point, which a run
reads to show that its path went through the kernels."""
from __future__ import annotations

SMEM_PER_CTA = 232448   # the most shared memory one CTA may use (sm_90)


def _kernel_modules():
    from repro_torch.kernels.chunk_reduce import kernel as chunk_reduce
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.wkv import kernel as wkv
    return chunk_reduce, flash, wkv


def launch_counts() -> dict:
    """{entry point: launches since the last reset} over every kernel."""
    return {k: v for mod in _kernel_modules() for k, v in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()
