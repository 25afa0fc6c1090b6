"""Tokens of all steps completed in the window over the window's seconds
(host clock)."""
from bench.harness import readings


def read(run):
    return readings.tokens_per_s(run)
