"""OptCC core of the port: the paper's flow model as a library.

Public API (the JAX package's `repro.core`, copied):
  BandwidthProfile, Flow, Op, Schedule       - flow model (core.model)
  validate_schedule_meta                     - Schedule.meta key contract
  simulate, simulate_many, SimResult         - bandwidth simulator
  execute, verify_allreduce                  - data-level verification on
                                               torch tensors (CPU or card)
  registry                                   - named schedule generators
                                               (ring/optcc/hierarchical/
                                               dbtree/torus2d)
  make_plan, Plan, topology_of               - online planner;
                                               make_plan(algo="auto"|name)
  lower_bounds                               - Theorems 1,2,3,6,13 + times,
                                               plus per-topology bounds

Everything but the executor is numpy and plain Python. The generators
themselves are imported from their modules (`repro_torch.core.ring`,
`repro_torch.core.schedule`); the JAX package's deprecated aliases for them
here are not ported.
"""
from repro_torch.core import lower_bounds, registry
from repro_torch.core.baselines import (iccl_time_asymptotic,
                                        iccl_time_simulated,
                                        nccl_no_failure_time, r2ccl_time)
from repro_torch.core.model import (BandwidthProfile, Flow, Op, Schedule,
                                    validate_schedule_meta)
from repro_torch.core.planner import Plan, make_plan, topology_of
from repro_torch.core.simulator import SimResult, simulate, simulate_many

__all__ = [
    "BandwidthProfile", "Flow", "Op", "Schedule", "SimResult", "simulate",
    "simulate_many", "validate_schedule_meta",
    "execute", "verify_allreduce", "registry", "make_plan", "Plan",
    "topology_of", "lower_bounds",
    "nccl_no_failure_time", "iccl_time_asymptotic", "iccl_time_simulated",
    "r2ccl_time",
]


def __getattr__(name: str):
    # the executor is core's one torch module: loaded when first asked for,
    # so the numpy users (planner, simulator, sweeps) start without torch
    if name in ("execute", "verify_allreduce"):
        from repro_torch.core import executor
        return getattr(executor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
