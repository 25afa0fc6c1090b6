"""The 95th percentile, nearest rank, of every AllReduce of the window,
each from its call to its result ready (CUDA events on the device's
clock)."""
from bench.harness import readings


def read(run):
    return readings.percentile(run.get("unit_ms", []), 95)
