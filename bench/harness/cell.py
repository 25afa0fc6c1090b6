"""One run of one cell: the driver that the traffic mix names, then every
metric the cell reports, each by its reader in `metrics/`, and the result
line."""
from __future__ import annotations

import time

import torch

from bench.harness import checks, spec as spec_mod


def run(spec, seed: int, seconds: float, trace: bool, device, say=print,
        t_start: float | None = None) -> dict:
    """The result line's object for one run of `spec`'s cell. `say`
    prints the run's earlier lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = spec_mod.driver(spec.traffic["driver"]).run(
        spec, seed, seconds, trace, device, say, t_start)
    out["spec"] = spec
    metrics = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        value = spec_mod.reader(m["name"])(out)
        if value is None and not trace:
            raise RuntimeError(f"{spec.name}: no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": out["peak"]}
    result = {"correct": False, "attempted": out["units"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        tr = out["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    ok, table, rest = checks.judge(out["values"], spec.limits)
    if rest:
        say({"not_compared": rest})
    result["correct"] = ok and out["failed"] == 0
    result["checks"] = table
    return result
