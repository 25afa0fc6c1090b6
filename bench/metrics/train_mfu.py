"""The whole step's share of the card's bf16 peak, in percent: the
benchmark's model FLOPs per token times the window's tokens per second."""
from bench.harness import readings, yardstick


def read(run):
    if "flops_per_token" not in run:
        return None
    return (100 * run["flops_per_token"] * readings.tokens_per_s(run) /
            yardstick.PEAK_BF16_FLOPS)
