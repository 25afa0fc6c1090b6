"""chunk_reduce's share of its roofline in one AllReduce, in percent, as
chunk_reduce_roofline.train."""
from bench.harness import readings


def read(run):
    return readings.roofline(run, "chunk_reduce")
