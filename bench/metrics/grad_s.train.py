"""Mean over the window's steps of the step's own grad_seconds: every
member's forward and backward and the packing of its gradients."""
from bench.harness import readings


def read(run):
    return readings.mean_of(run, "grad_seconds")
