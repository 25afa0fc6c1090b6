"""Arithmetic the metric readers in `metrics/` share. Each takes a run's
record (what the traffic's driver returned) and gives a number, or None
where the run holds nothing to read."""
from __future__ import annotations

import math
import statistics

from bench.harness import yardstick


def mean_of(run: dict, key: str):
    values = [r[key] for r in run.get("records", ())]
    return statistics.fmean(values) if values else None


def tokens_per_s(run: dict):
    if "unit_tokens" not in run:
        return None
    return run["units"] * run["unit_tokens"] / run["window_s"]


def percentile(values: list, q: float):
    """The nearest-rank q-th percentile."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(math.ceil(q / 100 * len(ranked)) - 1, 0)]


def _device(run: dict):
    tr = run.get("trace")
    return tr if tr is not None and tr.device else None


def roofline(run: dict, kernel: str):
    """The reduction's least time over the device time of every `kernel`
    launch, in percent, per traced unit."""
    tr = _device(run)
    if tr is None:
        return None
    seconds = tr.device_seconds(lambda name: kernel in name)
    if not seconds:
        return None
    least = yardstick.least_seconds(run["least_bytes"]) * run["traced_units"]
    return 100 * least / seconds


def copy_ms(run: dict):
    """Device milliseconds of copy kernels and device-to-device copies
    per traced unit."""
    tr = _device(run)
    if tr is None:
        return None
    seconds = tr.device_seconds(lambda name: "copy" in name.lower()
                                or name.startswith("Memcpy DtoD"))
    return 1e3 * seconds / run["traced_units"]


def idle_share(run: dict):
    """Percent of the traced window in which no device activity ran."""
    tr = _device(run)
    if tr is None or tr.window_s <= 0:
        return None
    return 100 * (1 - tr.busy_s() / tr.window_s)
