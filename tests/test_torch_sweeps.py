"""The port's fault-scenario sweeps (`repro_torch.sweeps`) held to the JAX
package's (`repro.sweeps`): tests/test_sweeps.py's cases on the port, the
CLI's deterministic smoke artifact with telemetry byte-equal to the JAX
CLI's (run in one subprocess), equal for 0 and 4 worker processes and
passing `ci/sweep_thresholds.json`, and one scenario's Chrome trace equal
to JAX's."""
import copy
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.sweeps import (SCHEMA, build_artifact,  # noqa: E402
                                canonical_bytes, check_thresholds, full_grid,
                                load_artifact, run_scenario, run_sweep,
                                sanity_check, smoke_grid, validate_artifact,
                                write_artifact)
from repro_torch.sweeps.artifact import percentile  # noqa: E402
from repro_torch.sweeps.cli import main as sweep_main  # noqa: E402
from repro_torch.sweeps.scenarios import ScenarioSpec  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
THRESHOLDS = REPO / "ci" / "sweep_thresholds.json"
# sha256 of the JAX package's `python -m repro.sweeps --smoke --telemetry
# --deterministic` artifact (seed 0); chip_smoke.py's `sweeps` phase holds
# the port's artifact on the card's host to it
JAX_SMOKE_SHA256 = \
    "b071e366dd80c2d29a9420cf72d0afca1081fa53deea6ada8641c4643b25049d"
SMOKE_ARGS = ["--smoke", "--telemetry", "--deterministic"]
TRACED = "single_p8_k12_l2.000_r0"

# tests/test_sweeps.py's thinned slice of the smoke grid: every 6th
# scenario keeps all the families
SUB = smoke_grid(seed=0)[::6]

_JAX_CLI = r"""
import sys
from repro.sweeps.cli import main
out = sys.argv[1]
assert main(["--smoke", "--telemetry", "--deterministic", "--workers", "4",
             "--out", out + "/jax_sweep.json"]) == 0
assert main(["--trace", sys.argv[2], "--trace-out",
             out + "/jax_trace.json"]) == 0
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{name: path}: the JAX CLI's smoke artifact and trace (a subprocess,
    started first and run meanwhile), the port's with 0 and 4 workers and
    its trace."""
    out = tmp_path_factory.mktemp("sweeps")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI, str(out), TRACED], env=env,
        cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        paths = {"port_w0": out / "port_w0.json",
                 "port_w4": out / "port_w4.json",
                 "port_trace": out / "port_trace.json"}
        assert sweep_main(SMOKE_ARGS + ["--workers", "0", "--out",
                                        str(paths["port_w0"])]) == 0
        assert sweep_main(SMOKE_ARGS + ["--workers", "4", "--out",
                                        str(paths["port_w4"])]) == 0
        assert sweep_main(["--trace", TRACED, "--trace-out",
                           str(paths["port_trace"])]) == 0
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    paths["jax"] = out / "jax_sweep.json"
    paths["jax_trace"] = out / "jax_trace.json"
    return paths


@pytest.fixture(scope="module")
def sub_results():
    return run_sweep(SUB, workers=0, measure_latency=False)


@pytest.fixture(scope="module")
def sub_artifact(sub_results):
    return build_artifact(sub_results, profile="smoke/6", seed=0,
                          deterministic=True)


# ----------------------------------------------------------------------------
# the port against the JAX package
# ----------------------------------------------------------------------------

def test_smoke_artifact_is_jax_byte_for_byte(cli_runs):
    port = cli_runs["port_w0"].read_bytes()
    assert port == cli_runs["jax"].read_bytes()
    assert hashlib.sha256(port).hexdigest() == JAX_SMOKE_SHA256
    obj = load_artifact(str(cli_runs["port_w0"]))
    assert obj["schema"] == SCHEMA and obj["telemetry"] is True
    assert obj["scenario_count"] == len(smoke_grid(seed=0))
    assert canonical_bytes(obj) == port


def test_chip_smoke_pins_the_same_hash():
    """chip_smoke.py's `sweeps` phase holds the card host's artifact to the
    same hash."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SWEEP_SHA256 == JAX_SMOKE_SHA256
    assert smoke.SWEEP_THRESHOLDS == str(THRESHOLDS.relative_to(REPO))


def test_workers_do_not_change_the_artifact(cli_runs):
    assert cli_runs["port_w4"].read_bytes() == \
        cli_runs["port_w0"].read_bytes()


def test_smoke_artifact_passes_the_ci_thresholds(cli_runs, capsys):
    assert sweep_main(["check", str(cli_runs["port_w0"]), "--thresholds",
                       str(THRESHOLDS)]) == 0
    assert "thresholds OK" in capsys.readouterr().out


def test_trace_is_jax_byte_for_byte(cli_runs):
    port = cli_runs["port_trace"].read_bytes()
    assert port == cli_runs["jax_trace"].read_bytes()
    events = json.loads(port)["traceEvents"]
    assert len(events) > 100


def test_summary_renders_the_artifact(cli_runs, capsys):
    assert sweep_main(["summary", str(cli_runs["port_w0"])]) == 0
    md = capsys.readouterr().out
    n = load_artifact(str(cli_runs["port_w0"]))["summary"]["overall"]["count"]
    assert f"| **overall** | {n} |" in md and "Critical-path stages" in md


# ----------------------------------------------------------------------------
# grids (tests/test_sweeps.py)
# ----------------------------------------------------------------------------

def test_grids_are_deterministic():
    a, b = smoke_grid(seed=0), smoke_grid(seed=0)
    assert a == b
    assert smoke_grid(seed=1) != a
    assert full_grid(seed=0) == full_grid(seed=0)


def test_smoke_grid_size_and_diversity():
    specs = smoke_grid(seed=0)
    assert len(specs) >= 200
    fams = {s.family for s in specs}
    assert {"healthy", "single", "multi", "multigpu", "correlated",
            "replay", "detection", "topology"} <= fams
    keys = {(s.p, s.n, s.k, s.slowdown, s.gpus_per_server, s.nvlink_mult,
             s.events, s.detection, s.algo)
            for s in specs}
    assert len(keys) == len(specs)
    full_fams = {s.family for s in full_grid(seed=0)}
    assert {"healthy", "single", "multi", "multigpu", "correlated",
            "replay", "detection", "topology"} <= full_fams


def test_heterogeneous_ells_present():
    hetero = [s for s in smoke_grid(seed=0) if s.family == "multi"
              and len(set(s.slowdown[i] for i in s.stragglers)) > 1]
    assert hetero


# ----------------------------------------------------------------------------
# engine and invariants
# ----------------------------------------------------------------------------

def test_sweep_results_dominate_lower_bound(sub_results):
    assert sanity_check(sub_results) == []
    for r in sub_results:
        assert r.t_optcc >= r.lower_bound * (1 - 1e-9), r.spec.name
        assert r.t0 > 0 and r.lower_bound > 0


def test_optcc_beats_degraded_ring_for_ell_le_2(sub_results):
    """The paper's regime: worst NIC keeps >= 50 % of its bandwidth =>
    OptCC's overhead <= the degraded ring's, scenario by scenario."""
    checked = 0
    for r in sub_results:
        if r.t_ring is None or not r.spec.stragglers:
            continue
        if r.spec.max_ell <= 2.0:
            assert r.overhead_optcc <= r.overhead_ring * (1 + 1e-9), \
                (r.spec.name, r.overhead_optcc, r.overhead_ring)
            checked += 1
    assert checked >= 10


def test_parallel_matches_serial():
    specs = SUB[:6]
    serial = run_sweep(specs, workers=0, measure_latency=False)
    par = run_sweep(specs, workers=2, measure_latency=False)
    for a, b in zip(serial, par):
        assert a.t_optcc == b.t_optcc
        assert a.t_ring == b.t_ring
        assert a.lower_bound == b.lower_bound


def test_single_scenario_healthy_ring_reuse():
    spec = ScenarioSpec(name="h", family="healthy", p=8, n=8 * 64, k=4,
                        slowdown=(1.0,) * 8)
    r = run_scenario(spec, measure_latency=False)
    assert r.algo == "ring"
    assert r.t_ring == r.t_optcc


# ----------------------------------------------------------------------------
# artifact
# ----------------------------------------------------------------------------

def test_artifact_schema_valid(sub_artifact):
    assert sub_artifact["schema"] == SCHEMA
    assert validate_artifact(sub_artifact) == []
    assert validate_artifact(json.loads(canonical_bytes(sub_artifact))) == []


def test_artifact_byte_identical_across_runs(sub_artifact):
    results2 = run_sweep(SUB, workers=0, measure_latency=False)
    art2 = build_artifact(results2, profile="smoke/6", seed=0,
                          deterministic=True)
    assert canonical_bytes(sub_artifact) == canonical_bytes(art2)


def test_validate_catches_corruption(sub_artifact):
    bad = copy.deepcopy(sub_artifact)
    bad["scenarios"][0]["t_optcc"] = bad["scenarios"][0]["lower_bound"] * 0.5
    assert any("lower bound" in e for e in validate_artifact(bad))
    bad = copy.deepcopy(sub_artifact)
    del bad["scenarios"][0]["overhead_optcc"]
    assert validate_artifact(bad)
    bad = copy.deepcopy(sub_artifact)
    bad["scenario_count"] += 1
    assert validate_artifact(bad)
    bad = copy.deepcopy(sub_artifact)
    bad["schema"] = "optcc-sweep/0"
    assert validate_artifact(bad)


def test_thresholds_gate(sub_artifact):
    ths = {"schema": "optcc-sweep-thresholds/1",
           "overhead_optcc_p99_max": 100.0,
           "optcc_vs_lb_max_max": 100.0,
           "min_scenarios": 1}
    assert check_thresholds(sub_artifact, ths) == []
    tight = dict(ths, overhead_optcc_p99_max=1.0)
    assert any("p99" in f for f in check_thresholds(sub_artifact, tight))
    many = dict(ths, min_scenarios=10 ** 6)
    assert check_thresholds(sub_artifact, many)
    assert check_thresholds(sub_artifact, {"schema": "nope"})


def test_percentile():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 99) == pytest.approx(99.01)
    assert percentile([7.0], 99) == 7.0
    assert percentile(xs, 0) == 1 and percentile(xs, 100) == 100


def test_topology_rows_scored_and_excluded_from_overall(sub_artifact):
    topo = [r for r in sub_artifact["scenarios"]
            if r["family"] == "topology"]
    assert topo
    for r in topo:
        assert r["requested_algo"] in ("hierarchical", "dbtree", "torus2d")
        assert r["t_auto"] > 0
        assert r["overhead_vs_auto"] == pytest.approx(
            r["t_optcc"] / r["t_auto"])
    assert set(sub_artifact["summary"]["by_algo"]) == \
        {r["requested_algo"] for r in topo}
    n_auto = len(sub_artifact["scenarios"]) - len(topo)
    assert sub_artifact["summary"]["overall"]["count"] == n_auto
    fam_stats = sub_artifact["summary"]["by_family"]["topology"]
    assert fam_stats["count"] == len(topo)
    assert "overhead_vs_auto_p99" in fam_stats


def test_validate_catches_topology_corruption(sub_artifact):
    bad = copy.deepcopy(sub_artifact)
    topo = next(r for r in bad["scenarios"] if r["family"] == "topology")
    del topo["t_auto"]
    assert any("t_auto" in e for e in validate_artifact(bad))
    bad = copy.deepcopy(sub_artifact)
    other = next(r for r in bad["scenarios"] if r["family"] != "topology")
    other["t_auto"] = 1.0
    assert any("non-topology" in e for e in validate_artifact(bad))
    bad = copy.deepcopy(sub_artifact)
    del bad["summary"]["by_algo"]
    assert any("by_algo" in e for e in validate_artifact(bad))


# ----------------------------------------------------------------------------
# schema migration chain (v1 -> v2 -> v3 -> v4 -> v5)
# ----------------------------------------------------------------------------

def _v1_artifact(deterministic: bool = True) -> dict:
    """tests/test_sweeps.py's minimal optcc-sweep/1 artifact: 0.0 (not
    null) for unmeasured wall-clock fields, no telemetry, no replay or
    detection families, no retry counter."""
    summary_stats = {
        "count": 1,
        "overhead_optcc_p50": 1.5, "overhead_optcc_p99": 1.5,
        "overhead_optcc_max": 1.5,
        "optcc_vs_lb_p50": 1.0, "optcc_vs_lb_p99": 1.0,
        "optcc_vs_lb_max": 1.0,
        "gen_ms_p50": 0.0, "gen_ms_p99": 0.0,
    }
    return {
        "schema": "optcc-sweep/1",
        "profile": "smoke", "seed": 0,
        "deterministic": deterministic,
        "schedgen_latency_ms": None,
        "scenario_count": 1,
        "summary": {"overall": dict(summary_stats), "by_family": {}},
        "scenarios": [{
            "name": "s", "family": "single", "algo": "optcc",
            "p": 8, "k": 4, "n": 448, "gpus_per_server": 1,
            "nvlink_mult": None, "num_flows": 10,
            "stragglers": [0], "ells": [1.5],
            "t0": 100.0, "lower_bound": 120.0, "t_optcc": 150.0,
            "t_ring": 160.0, "t_predicted": 150.0,
            "overhead_optcc": 1.5, "overhead_ring": 1.6,
            "overhead_lb": 1.2, "optcc_vs_lb": 1.25,
            "gen_ms": 0.0, "sim_ms": 0.0,
        }],
    }


def _load_from(tmp_path, obj) -> dict:
    path = str(tmp_path / "a.json")
    write_artifact(obj, path)
    return load_artifact(path)


def test_migration_v1_to_current(tmp_path):
    got = _load_from(tmp_path, _v1_artifact())
    assert got["schema"] == SCHEMA
    assert got["telemetry"] is False
    assert got["retries"] is None
    assert got["scenarios"][0]["gen_ms"] is None
    assert got["scenarios"][0]["sim_ms"] is None
    assert got["summary"]["overall"]["gen_ms_p50"] is None
    assert validate_artifact(got) == []


def test_migration_v1_measured_keeps_latencies(tmp_path):
    got = _load_from(tmp_path, _v1_artifact(deterministic=False))
    assert got["schema"] == SCHEMA
    assert got["scenarios"][0]["gen_ms"] == 0.0
    assert validate_artifact(got) == []


def test_migration_v1_empty_families_and_scenarios(tmp_path):
    obj = _v1_artifact()
    obj["scenarios"] = []
    obj["scenario_count"] = 0
    obj["summary"]["by_family"] = {}
    got = _load_from(tmp_path, obj)
    assert got["schema"] == SCHEMA and got["retries"] is None


def test_migration_v1_missing_optional_keys(tmp_path):
    obj = _v1_artifact()
    del obj["schedgen_latency_ms"]
    got = _load_from(tmp_path, obj)
    assert got["schema"] == SCHEMA
    assert validate_artifact(got) == []


def test_migration_v3_to_current(tmp_path, sub_artifact):
    obj = copy.deepcopy(sub_artifact)
    obj["schema"] = "optcc-sweep/3"
    del obj["retries"]
    obj["scenarios"] = [r for r in obj["scenarios"]
                        if r["family"] != "topology"]
    obj["scenario_count"] = len(obj["scenarios"])
    del obj["summary"]["by_algo"]
    got = _load_from(tmp_path, obj)
    assert got["schema"] == SCHEMA
    assert got["retries"] is None
    assert validate_artifact(got) == []
    got2 = _load_from(tmp_path, sub_artifact)
    assert got2["retries"] == 0


def test_migration_v4_to_v5(tmp_path, sub_artifact):
    obj = copy.deepcopy(sub_artifact)
    obj["schema"] = "optcc-sweep/4"
    obj["scenarios"] = [r for r in obj["scenarios"]
                        if r["family"] != "topology"]
    obj["scenario_count"] = len(obj["scenarios"])
    del obj["summary"]["by_algo"]
    got = _load_from(tmp_path, obj)
    assert got["schema"] == SCHEMA
    assert validate_artifact(got) == []
    assert "by_algo" not in got["summary"]


# ----------------------------------------------------------------------------
# worker fan-out
# ----------------------------------------------------------------------------

def test_run_sweep_records_zero_retries_on_clean_run():
    stats = {}
    res = run_sweep(SUB[:8], workers=2, measure_latency=False, stats=stats)
    assert stats["retries"] == 0
    assert [r.spec.name for r in res] == [s.name for s in SUB[:8]]
    ser = run_sweep(SUB[:8], workers=0, measure_latency=False)
    assert [r.t_optcc for r in res] == [r.t_optcc for r in ser]


def test_run_sweep_serial_ignores_pool_machinery():
    stats = {}
    res = run_sweep(SUB[:2], workers=0, measure_latency=False, stats=stats)
    assert len(res) == 2 and stats["retries"] == 0

