from repro_torch.comms.collectives import (optcc_allreduce,
                                           optcc_allreduce_,
                                           optcc_allreduce_tree, psum,
                                           psum_tree, ring_all_gather,
                                           ring_allreduce,
                                           ring_reduce_scatter)
from repro_torch.comms.transport import LocalTransport

__all__ = ["LocalTransport", "optcc_allreduce", "optcc_allreduce_",
           "optcc_allreduce_tree", "psum", "psum_tree", "ring_all_gather",
           "ring_allreduce", "ring_reduce_scatter"]
