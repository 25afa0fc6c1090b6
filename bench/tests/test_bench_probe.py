"""The training check's numbers: a gradient read along seeded random
directions catches what its norm misses, the two sides read the same
directions, and the numbers come from one function (`checks.
train_values`) for the run and for the calibration alike."""
import pytest
import torch

from bench.harness import checks
from bench.reference import probe


def _leaves(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(3000, generator=gen),
            "b": torch.randn(40, 50, generator=gen) * 3,
            "c": torch.randn(7, generator=gen) * 1e-3}


def test_the_same_directions_bit_for_bit(monkeypatch):
    leaves = _leaves(1)
    once = probe.project(leaves, 2 ** 40 + 7)
    assert once == probe.project({k: v.clone() for k, v in leaves.items()},
                                 2 ** 40 + 7)
    assert once != probe.project(leaves, 2 ** 40 + 8)
    assert all(len(v) == probe.COUNT for v in once.values())
    # a leaf longer than a block is drawn block by block, as repeatably
    whole = probe.project(leaves, 5)
    monkeypatch.setattr(probe, "BLOCK", 1000)
    blocks = probe.project(leaves, 5)
    assert blocks == probe.project(leaves, 5)
    assert blocks["a"] != whole["a"] and blocks["c"] == whole["c"]


def test_scale_is_linear():
    leaves = _leaves(2)
    one, two = probe.project(leaves, 9), probe.project(leaves, 9, 2.0)
    for k in one:
        assert two[k] == pytest.approx([2 * x for x in one[k]], rel=1e-12)


def test_a_sign_flip_shows_along_directions_and_not_in_norms():
    ref = _leaves(3)
    flipped = dict(ref, b=-ref["b"])
    norms = {k: v.double().norm().item() for k, v in ref.items()}
    prog_norms = {k: v.double().norm().item() for k, v in flipped.items()}
    assert max(checks.leaf_gaps(prog_norms, norms).values()) == 0.0
    gaps = checks.direction_gaps(probe.project(flipped, 4),
                                 probe.project(ref, 4), norms)
    assert gaps["a"] == 0.0 and gaps["c"] == 0.0
    assert gaps["b"] > 0.5


@pytest.mark.parametrize("n", [1000, 100_000])
def test_a_gap_along_directions_reads_the_difference_norm(n):
    """<e, v> is normal with standard deviation |e|: over many leaves the
    mean square of the projections of e of norm 1 is about 1."""
    gen = torch.Generator().manual_seed(n)
    errs = {f"e{i}": torch.nn.functional.normalize(
        torch.randn(n, generator=gen), dim=0) for i in range(64)}
    proj = probe.project(errs, 6)
    mean_sq = sum(x * x for v in proj.values() for x in v) / (
        64 * probe.COUNT)
    assert 0.75 < mean_sq < 1.3


def test_train_values_names_the_worst_leaves():
    ref = {"loss": [2.0, 1.0], "first_grad": {"x": 1.0, "y": 2.0, "z": 1e-9},
           "first_proj": {"x": [1.0, 0.0], "y": [0.0, 2.0], "z": [0, 0]},
           "change": {"x": 0.1, "y": 0.2, "z": 0.5}}
    prog = {"loss": [2.0, 1.1], "first_grad": {"x": 1.0, "y": 2.2, "z": 0},
            "first_proj": {"x": [-1.0, 0.0], "y": [0.0, 2.0], "z": [0, 0]},
            "change": {"x": 0.1, "y": 0.2, "z": 9.0}}
    worst = {}
    got = checks.train_values(prog, ref, worst)
    assert got["loss"] == pytest.approx(0.1)
    # gaps over the larger of the leaf's and the median leaf's norm (1.0)
    assert got["first_grad"] == pytest.approx(0.1)
    assert got["first_grad_dir"] == pytest.approx(2.0)
    # z's reference gradient is nought: its change is not compared
    assert got["param_change"] == 0.0
    assert worst == {"first_grad": "y", "first_grad_dir": "x",
                     "param_change": "x"}
