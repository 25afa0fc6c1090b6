"""Device milliseconds per AllReduce of copy kernels and device-to-device
copies: packing, unpacking and the transport's hops (torch.profiler)."""
from bench.harness import readings


def read(run):
    return readings.copy_ms(run)
