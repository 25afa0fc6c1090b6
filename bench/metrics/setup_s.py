"""Seconds from the process's start to the window's: imports, the card,
building or loading the kernels, the seeded inputs and the warm-up (host
clock)."""


def read(run):
    return run["setup_s"]
