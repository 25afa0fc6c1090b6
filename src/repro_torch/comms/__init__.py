from repro_torch.comms.collectives import (compressed_psum, dequantize_int8,
                                           hierarchical_psum,
                                           optcc_allreduce,
                                           optcc_allreduce_,
                                           optcc_allreduce_tree, psum,
                                           psum_tree, quantize_int8,
                                           ring_all_gather,
                                           ring_allreduce,
                                           ring_reduce_scatter)
from repro_torch.comms.transport import LocalTransport, ProcessTransport

__all__ = ["LocalTransport", "ProcessTransport", "compressed_psum",
           "dequantize_int8", "hierarchical_psum", "optcc_allreduce",
           "optcc_allreduce_", "optcc_allreduce_tree", "psum", "psum_tree",
           "quantize_int8", "ring_all_gather", "ring_allreduce",
           "ring_reduce_scatter"]
