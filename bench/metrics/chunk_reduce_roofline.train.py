"""chunk_reduce's share of its roofline in a training step, in percent: the
gradient sum's least time (each member's vector read once and the sum
written once, in the gradient's own dtype, at the card's peak bandwidth)
over the device time of every chunk_reduce launch (torch.profiler)."""
from bench.harness import readings


def read(run):
    return readings.roofline(run, "chunk_reduce")
