"""Mean over the window's steps of the step's own sync_seconds: the
collective, from the last member's packed gradients to the synced ones."""
from bench.harness import readings


def read(run):
    return readings.mean_of(run, "sync_seconds")
