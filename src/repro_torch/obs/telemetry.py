"""Per-flow telemetry collected from a finished simulation.

`collect` turns a (schedule, SimResult) pair into columnar per-flow records:
start/finish/duration by fid, endpoints, stage tags, the dependency CSR, and
per-port busy intervals. Everything is *derived* from the times the
simulator already computed - collection never re-times anything, so results
with and without telemetry are IEEE-754 identical by construction.

Port id encoding follows the simulator: ``rank * 4 + (2 if nvlink) +
(1 if recv side)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.flowvec import FlowArrays
from repro_torch.core.model import STAGE_NAMES, Schedule


def stage_name(sid: int) -> str:
    """Human name for a stage id; untagged schedules report 'UNK'."""
    return STAGE_NAMES[sid] if 0 <= sid < len(STAGE_NAMES) else "UNK"


@dataclasses.dataclass
class FlowTelemetry:
    """Columnar per-flow telemetry, indexed by fid (0..N-1).

    `wire` marks flows that occupy ports (size > 0); zero-size self-stores
    are bookkeeping and never appear in port interval accounting.
    """

    makespan: float
    p: int                     # ranks
    gpus_per_server: int
    algo: str                  # schedule.meta["algo"] (or "?")
    start: np.ndarray          # float64 [N]
    finish: np.ndarray         # float64 [N]
    size: np.ndarray           # float64 [N]
    src: np.ndarray            # int64 [N]
    dst: np.ndarray            # int64 [N]
    nv: np.ndarray             # bool [N]
    stage_ids: np.ndarray      # int16 [N]; -1 = untagged
    dep_indptr: np.ndarray     # int64 [N+1]
    dep_indices: np.ndarray    # int64 [nnz]

    @property
    def nflows(self) -> int:
        return len(self.size)

    @property
    def duration(self) -> np.ndarray:
        return self.finish - self.start

    @property
    def wire(self) -> np.ndarray:
        return self.size > 0

    def deps_of(self, fid: int) -> np.ndarray:
        return self.dep_indices[self.dep_indptr[fid]:self.dep_indptr[fid + 1]]

    def stage_of(self, fid: int) -> str:
        return stage_name(int(self.stage_ids[fid]))

    def sport(self, fid: int) -> int:
        return int(self.src[fid]) * 4 + int(self.nv[fid]) * 2

    def rport(self, fid: int) -> int:
        return int(self.dst[fid]) * 4 + int(self.nv[fid]) * 2 + 1


def collect(schedule: Schedule, result) -> FlowTelemetry:
    """Build FlowTelemetry from a simulated schedule.

    `result` is a `core.simulator.SimResult`; its lazily-materialized
    start/finish dicts are read here (the one place the off-path laziness is
    paid for, which is why telemetry is opt-in).
    """
    fa = schedule.arrays if schedule.arrays is not None \
        else FlowArrays.from_schedule(schedule)
    n = fa.nflows
    s, f = result.start, result.finish
    start = np.fromiter((s[i] for i in range(n)), np.float64, count=n)
    finish = np.fromiter((f[i] for i in range(n)), np.float64, count=n)
    sids = schedule.meta.get("stage_ids")
    stage_ids = np.asarray(sids, np.int16) if sids is not None \
        else np.full(n, -1, np.int16)
    if len(stage_ids) != n:
        raise ValueError(
            f"stage_ids length {len(stage_ids)} != {n} flows")
    return FlowTelemetry(
        makespan=result.makespan,
        p=schedule.profile.p,
        gpus_per_server=schedule.profile.gpus_per_server,
        algo=str(schedule.meta.get("algo", "?")),
        start=start, finish=finish,
        size=fa.size, src=fa.src, dst=fa.dst, nv=fa.nv,
        stage_ids=stage_ids,
        dep_indptr=fa.dep_indptr, dep_indices=fa.dep_indices)


def port_intervals(tele: FlowTelemetry) -> dict[tuple, np.ndarray]:
    """{(kind, rank, dir): (m, 3) array of [start, finish, fid] rows},
    sorted by start. Ports are exclusive, so each port's intervals are
    non-overlapping (up to shared endpoints); tests pin this invariant.
    """
    w = np.nonzero(tele.wire)[0]
    out: dict[tuple, np.ndarray] = {}
    if not len(w):
        return out
    nvw = tele.nv[w].astype(np.int64)
    for pid_arr, d in ((tele.src[w] * 4 + nvw * 2, "s"),
                      (tele.dst[w] * 4 + nvw * 2 + 1, "r")):
        for pid in np.unique(pid_arr):
            sel = w[pid_arr == pid]
            o = np.argsort(tele.start[sel], kind="stable")
            sel = sel[o]
            kind = "nv" if pid & 2 else "nic"
            out[(kind, int(pid) // 4, d)] = np.column_stack(
                (tele.start[sel], tele.finish[sel],
                 sel.astype(np.float64)))
    return out


def port_utilization(tele: FlowTelemetry) -> dict[tuple, float]:
    """{(kind, rank, dir): busy fraction of the makespan}."""
    if tele.makespan <= 0:
        return {}
    w = np.nonzero(tele.wire)[0]
    busy: dict[tuple, float] = {}
    durs = tele.finish[w] - tele.start[w]
    nvw = tele.nv[w]
    for i, fid in enumerate(w):
        kind = "nv" if nvw[i] else "nic"
        for key in ((kind, int(tele.src[fid]), "s"),
                    (kind, int(tele.dst[fid]), "r")):
            busy[key] = busy.get(key, 0.0) + float(durs[i])
    return {k: v / tele.makespan for k, v in busy.items()}
