from repro_torch.kernels.chunk_reduce.ops import chunk_reduce, chunk_reduce_pairs_

__all__ = ["chunk_reduce", "chunk_reduce_pairs_"]
