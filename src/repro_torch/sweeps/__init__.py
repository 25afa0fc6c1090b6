"""Fault-scenario sweep engine.

Generates large deterministic grids of degradation scenarios (single/multi
straggler, multi-GPU servers, heterogeneous slowdowns, correlated server
faults), runs each through the online planner + bandwidth simulator, scores
against the paper's lower bounds, and emits a versioned JSON perf artifact
(BENCH_sweep.json) that CI gates on. See `python -m repro_torch.sweeps --help`.

The port's copy of `repro/sweeps/`: numpy and plain Python, imports
rewritten to `repro_torch.`, so a deterministic artifact is the JAX
package's byte for byte (tests/test_torch_sweeps.py) and passes the same
thresholds (`ci/sweep_thresholds.json`). The worker processes import only
`repro_torch`.

Public API:
  ScenarioSpec, smoke_grid, full_grid, GRIDS   - scenario grids
  run_scenario, run_sweep, ScenarioResult      - execution engine
  build_artifact, validate_artifact,
  check_thresholds, write_artifact,
  load_artifact, canonical_bytes               - artifact I/O + gating
"""
from repro_torch.sweeps.artifact import (SCHEMA, THRESHOLDS_SCHEMA, build_artifact,
                                   canonical_bytes, check_thresholds,
                                   load_artifact, validate_artifact,
                                   write_artifact)
from repro_torch.sweeps.engine import (ScenarioResult, grid_for, run_scenario,
                                 run_sweep, sanity_check)
from repro_torch.sweeps.scenarios import (GRIDS, PAPER_ELLS, ScenarioSpec,
                                    full_grid, gen_detection, gen_replay,
                                    load_trace, smoke_grid, traces_dir)
from repro_torch.sweeps.stats import percentile, percentile_or_none, summarize

__all__ = [
    "ScenarioSpec", "ScenarioResult", "GRIDS", "PAPER_ELLS",
    "smoke_grid", "full_grid", "grid_for",
    "gen_detection", "gen_replay", "load_trace", "traces_dir",
    "run_scenario", "run_sweep", "sanity_check",
    "SCHEMA", "THRESHOLDS_SCHEMA",
    "build_artifact", "canonical_bytes", "validate_artifact",
    "check_thresholds", "write_artifact", "load_artifact",
    "percentile", "percentile_or_none", "summarize",
]
