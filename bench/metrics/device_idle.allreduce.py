"""Percent of the traced AllReduces' window in which the device ran nothing
(torch.profiler)."""
from bench.harness import readings


def read(run):
    return readings.idle_share(run)
