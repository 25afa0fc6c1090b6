"""Mean over the window's steps of the step's own update_seconds: AdamW."""
from bench.harness import readings


def read(run):
    return readings.mean_of(run, "update_seconds")
