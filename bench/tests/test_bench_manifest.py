"""BENCHMARK.json against the benchmark's contract, and each name it holds
against the file that the harness finds by it."""
import json
import pathlib
import re

import pytest
import torch

from bench.harness import spec as spec_mod
from bench.reference import decoder

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for path in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(word) for word in MAN["command"])
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_text():
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for entry in MAN["configs"] + MAN["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
        for key in TEXT_KEYS:
            if key in entry:
                assert _line(entry[key]), (entry["name"], key)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")


def test_cells_configs_and_chips():
    configs = {c["name"] for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == configs, "every configuration has a cell"
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["configs"]) <= 24


def test_metrics_sources_bounds_and_moves():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for m in MAN["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(reports(m, cell) for m in MAN["per_layer"])
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_name_finds_its_file():
    bench = ROOT / "bench"
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        cfg = json.loads(path.read_text())
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert {"assumed", "deployment"} <= set(cfg)
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for w in MAN["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
        spec = spec_mod.load(w["name"])
        assert spec.limits, w["name"]
    for m in METRICS:
        assert callable(spec_mod.reader(m["name"]))


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (ROOT / "bench" / "traffic").glob("*.json")))
def test_every_traffic_names_its_driver(traffic):
    """A traffic mix names the driver of its kind, found by that name
    alone: a new kind is a new file under harness/drivers/."""
    mix = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json")
                     .read_text())
    drv = spec_mod.driver(mix["driver"])
    assert drv.__name__ == f"bench.harness.drivers.{mix['driver']}"
    assert callable(drv.run) and callable(drv.calibration)


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_layout_is_the_programs(config):
    """The parameters the benchmark makes have the names, shapes and dtypes
    the program's own init gives, at the configuration's full size."""
    from bench.harness.drivers.train import port_config
    from repro_torch.models import build_model
    from repro_torch.sharding import eval_shape
    entry = {c["name"]: c for c in MAN["configs"]}[config]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    model = build_model(port_config(cfg))
    port = eval_shape(model.init, 0, "cpu")
    mine = decoder.param_layout(cfg)
    assert list(port) == list(mine)
    for k, (shape, dtype, _) in mine.items():
        assert tuple(port[k].shape) == shape, k
        assert port[k].dtype == getattr(torch, dtype), k
