"""Bandwidth profile of the flow model (a copy of `repro/core/model.py`'s
`BandwidthProfile`).

A healthy NIC moves one element per time unit; a NIC with slowdown factor
l > 1 takes l units per element. The port's planner reads the profile; the
flow graph, the schedules and the simulator stay in the JAX package until
the slice that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class BandwidthProfile:
    """Per-rank NIC slowdown factors. slowdown[i] == 1.0 means healthy.

    For the multi-GPU/server setting, `gpus_per_server` > 1 and ranks are
    grouped server-major: server j owns ranks [j*g, (j+1)*g). NVLink rate is
    (g-1)x the NIC rate per the paper's provisioning assumption.
    """

    p: int
    slowdown: tuple[float, ...]
    gpus_per_server: int = 1
    # NVLink per-direction bandwidth as a multiple of one NIC. None ->
    # the paper's provisioning assumption (g-1)x, the *minimum* that hides
    # intra-server traffic. Real hardware has more headroom (DGX A100:
    # 2400 Gbps NVLink vs 200 Gbps NIC = 12x; paper footnote 4).
    nvlink_mult: float | None = None

    @property
    def nvlink_rate(self) -> float:
        if self.nvlink_mult is not None:
            return self.nvlink_mult
        return max(self.gpus_per_server - 1, 1)

    def __post_init__(self):
        if len(self.slowdown) != self.p:
            raise ValueError(f"slowdown must have length p={self.p}")
        if any(l < 1.0 for l in self.slowdown):
            raise ValueError("slowdown factors must be >= 1")
        if self.p % self.gpus_per_server:
            raise ValueError("p must be divisible by gpus_per_server")

    @classmethod
    def healthy(cls, p: int, g: int = 1) -> "BandwidthProfile":
        return cls(p=p, slowdown=(1.0,) * p, gpus_per_server=g)

    @classmethod
    def single_straggler(cls, p: int, ell: float, straggler: int = 0,
                         g: int = 1) -> "BandwidthProfile":
        sl = [1.0] * p
        if g == 1:
            sl[straggler] = ell
        else:
            # straggler is a *server* index; all its GPUs' NICs degrade (PXN).
            for r in range(straggler * g, (straggler + 1) * g):
                sl[r] = ell
        return cls(p=p, slowdown=tuple(sl), gpus_per_server=g)

    @classmethod
    def multi_straggler(cls, p: int, ells: Sequence[float],
                        stragglers: Optional[Sequence[int]] = None
                        ) -> "BandwidthProfile":
        if stragglers is None:
            stragglers = list(range(len(ells)))
        sl = [1.0] * p
        for r, l in zip(stragglers, ells):
            sl[r] = l
        return cls(p=p, slowdown=tuple(sl))

    @property
    def stragglers(self) -> tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.slowdown) if l > 1.0)

    @property
    def max_ell(self) -> float:
        return max(self.slowdown)

    @property
    def num_servers(self) -> int:
        return self.p // self.gpus_per_server
