"""What a cell is made of, found by the names in BENCHMARK.json: its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), which names the driver of its kind
(`harness/drivers/<driver>.py`), the limits of its correctness check
(`limits/<cell>.json`) and the readers of its metrics
(`metrics/<metric>.py`). A new cell, mix, kind or metric is a new file."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Spec:
    cell: dict              # the workload's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: Optional[dict]  # {number: limit}; None before they are set
    end_to_end: list        # the metric entries this cell reports
    per_layer: list

    @property
    def name(self) -> str:
        return self.cell["name"]


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: pathlib.Path = ROOT) -> Spec:
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in man["configs"]}[cell["config"]]
    bench = root / "bench"
    limits_path = bench / "limits" / f"{workload}.json"
    limits = None
    if limits_path.exists():
        limits = {k: v["limit"] for k, v in
                  json.loads(limits_path.read_text())["numbers"].items()}
    return Spec(
        cell=cell,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((bench / "traffic" /
                            f"{cell['traffic']}.json").read_text()),
        limits=limits,
        end_to_end=[m for m in man["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in man["per_layer"] if _reports(m, workload)])


def reader(metric: str, bench: pathlib.Path = BENCH):
    """The `read(run)` function of metrics/<metric>.py."""
    path = bench / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The module harness/drivers/<name>.py: `run(spec, seed, seconds,
    trace, device, say, t_start)` gives one run's record, and
    `calibration(spec, seed, device, sides, ref)` the (side, readings) of
    its controls and faults."""
    return importlib.import_module(f"bench.harness.drivers.{name}")
