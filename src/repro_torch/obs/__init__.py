"""Observability layer: per-flow telemetry, critical-path stage attribution
and Chrome-trace export for the flow simulator.

Strictly opt-in: nothing here is imported by the simulator's timing paths,
and `simulate(schedule, telemetry=True)` derives everything post-hoc from
the start/finish times the simulator already records - enabling telemetry
cannot change a single bit of any simulated timing.
"""
from repro_torch.obs.critical_path import critical_path, stage_breakdown
from repro_torch.obs.telemetry import (FlowTelemetry, collect, port_intervals,
                                 port_utilization, stage_name)
from repro_torch.obs.trace import chrome_trace, write_chrome_trace

__all__ = [
    "FlowTelemetry",
    "collect",
    "port_intervals",
    "port_utilization",
    "stage_name",
    "critical_path",
    "stage_breakdown",
    "chrome_trace",
    "write_chrome_trace",
]
