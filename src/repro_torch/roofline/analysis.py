"""Roofline terms of a dry-run cell (the port of `repro/roofline/analysis.py`).

Hardware model, one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data
sheet; the same constants as `chip_smoke.py`'s bounds):
  peak bf16 compute : 989 TFLOP/s dense (tensor cores)
  HBM bandwidth     : 3.35 TB/s (HBM3)
  link bandwidth    : 450 GB/s a direction (NVLink 4: 18 links of 25 GB/s
                      each way, 900 GB/s both ways)

  compute term    = FLOPs / peak
  memory term     = HBM bytes / HBM_bw
  collective term = collective bytes / link_bw

The inputs come from `repro_torch.roofline.op_count` (the eager program's
ops). The port has no SPMD partitioner, so a cell's collective bytes may
be unknown (None): then its collective term is None and stays out of
`dominant` and `bound_time`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
LINK_BW = 450e9              # bytes/s a direction (NVLink 4), ICI_BW's twin


@dataclasses.dataclass
class Roofline:
    flops: float                        # per device
    bytes_hbm: float                    # per device
    bytes_collective: Optional[float]   # per device; None: not counted
    model_flops: float                  # 6*N*D (active params), whole step
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.bytes_collective is None:
            return None
        return self.bytes_collective / LINK_BW

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs * chips): remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the roofline the step achieves if it runs exactly at
        the binding resource: useful model FLOPs per second at bound_time
        over the chips' peak."""
        if self.bound_time == 0:
            return 0.0
        achieved = self.model_flops / self.bound_time / self.chips
        return achieved / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.bytes_hbm,
            "collective_bytes_per_device": self.bytes_collective,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }
