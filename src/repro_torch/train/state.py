"""TrainState: parameters, optimizer state and the step count."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int
