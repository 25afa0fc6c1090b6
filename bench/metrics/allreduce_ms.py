"""The window's milliseconds over the AllReduces completed in it (host
clock)."""


def read(run):
    if "unit_ms" not in run:
        return None
    return 1e3 * run["window_s"] / run["units"]
