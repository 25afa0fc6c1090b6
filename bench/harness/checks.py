"""The numbers that decide `correct`, each a gap between what the timed
path produced and the plain reference, and their comparison with the
cell's limits."""
from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam; it is left out of the change
NOUGHT_GRAD = 1e-3


def rel_gap(prog: list, ref: list) -> float:
    """max |prog - ref| / |ref| over paired values (the steps' losses)."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog norm - ref norm|, over the larger of that leaf's
    ref norm and the median leaf's."""
    median = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in ref
            if keep is None or k in keep}


def moving_leaves(ref_first_grad: dict) -> set:
    median = statistics.median(ref_first_grad.values())
    return {k for k, v in ref_first_grad.items() if v >= NOUGHT_GRAD * median}


def direction_gaps(prog: dict, ref: dict, ref_norms: dict) -> dict:
    """Each leaf's worst |prog - ref| over its projections (`reference.
    probe`), over the larger of that leaf's ref norm and the median
    leaf's."""
    median = statistics.median(ref_norms.values())
    return {k: max(abs(p - r) for p, r in zip(prog[k], ref[k]))
            / max(ref_norms[k], median) for k in ref}


def train_values(prog: dict, ref: dict, worst: dict | None = None) -> dict:
    """The numbers a training cell compares, from the readings of the
    checked steps on two sides (`loss` per step; per leaf the first
    gradient's norm `first_grad` and projections `first_proj`, and the
    norm of its `change`): the steps' losses; the worst leaf's gap of the
    first gradient's norm, and along its directions; the worst moving
    leaf's gap of its change. `worst`, where given, gets each number's
    worst leaf."""
    gaps = {"first_grad": leaf_gaps(prog["first_grad"], ref["first_grad"]),
            "first_grad_dir": direction_gaps(prog["first_proj"],
                                             ref["first_proj"],
                                             ref["first_grad"]),
            "param_change": leaf_gaps(prog["change"], ref["change"],
                                      moving_leaves(ref["first_grad"]))}
    if worst is not None:
        worst.update({k: max(v, key=v.get) for k, v in gaps.items()})
    return {"loss": rel_gap(prog["loss"], ref["loss"]),
            **{k: max(v.values()) for k, v in gaps.items()}}


def judge(values: dict, limits) -> tuple[bool, dict, dict]:
    """(correct, {number: {"value", "limit"}} of the numbers compared, the
    readings of those not compared): every number that has a limit finite
    and at most it; with no limits set, nothing is correct."""
    if limits is None:
        return False, {k: {"value": v, "limit": None}
                       for k, v in values.items()}, {}
    table = {k: {"value": values[k], "limit": lim}
             for k, lim in limits.items()}
    ok = all(math.isfinite(t["value"]) and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table, {k: v for k, v in values.items() if k not in limits}
