"""Shared summary statistics for artifacts, benchmarks and telemetry.

One home for the pure-Python percentile math of the sweep artifact
(`repro_torch.sweeps.artifact`) and the per-stage telemetry summaries
(`repro_torch.obs`). Pure Python so artifact bytes never depend on the numpy
version.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy 'linear'), pure Python so the
    artifact bytes don't depend on the numpy version."""
    if not values:
        return math.nan
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def percentile_or_none(values: Sequence[Optional[float]],
                       q: float) -> Optional[float]:
    """Percentile over the non-None entries; None when nothing is measured
    (deterministic artifacts null out wall-clock fields entirely)."""
    xs = [v for v in values if v is not None]
    if not xs:
        return None
    return percentile(xs, q)


def summarize(values: Sequence[float],
              qs: Sequence[float] = (50.0, 99.0)) -> dict[str, float]:
    """{'p50': ..., 'p99': ..., 'max': ...} for a sample; percentile keys
    follow the requested qs (integral qs render as pNN)."""
    out: dict[str, float] = {}
    for q in qs:
        tag = f"p{q:g}".replace(".", "_")
        out[tag] = percentile(values, q)
    out["max"] = max(values) if values else math.nan
    return out
