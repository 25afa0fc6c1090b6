from repro_torch.kernels.wkv.ops import wkv

__all__ = ["wkv"]
