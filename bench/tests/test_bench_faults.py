"""A whole run of each cell, past the look for a card, with the timed path
broken underneath: `correct` has to come out false for every fault the
cell can have, and true without one. Small float32 cells on the CPU, held
to the cells' own limits."""
import time

import pytest
import torch

import repro_torch.comms as comms
import repro_torch.models.transformer as transformer
import repro_torch.train.step as step_mod
from bench.harness import cell
from bench_cells import ALLREDUCE, TRAIN, small_spec


def _run(name):
    return cell.run(small_spec(name), 21, 0.0, False, torch.device("cpu"),
                    lambda obj: None, time.perf_counter())


def _first_member(members):
    """The first member's leaves, the others consumed unsummed."""
    members = iter(members)
    first = [leaf.clone() for leaf in next(members)]
    for _ in members:
        pass
    return first


def _altered(leaves):
    """One element of the answer moved by its leaf's norm."""
    leaves[0].view(-1)[0] += leaves[0].norm()
    return leaves


def _plant_train(monkeypatch, fault):
    if fault == "unchanged":
        def update(params, grads, state, lr, cfg):
            return params, state, torch.zeros(())
        monkeypatch.setattr(step_mod, "update", update)
    elif fault == "half_batch":
        loss_fn = transformer.loss_fn

        def half(cfg, params, batch):
            return loss_fn(cfg, params, {k: v[:v.shape[0] // 2]
                                         for k, v in batch.items()})
        monkeypatch.setattr(transformer, "loss_fn", half)
    elif fault == "no_exchange":
        monkeypatch.setattr(step_mod, "psum_tree",
                            lambda members, tr: _first_member(members))
        monkeypatch.setattr(step_mod, "optcc_allreduce_tree",
                            lambda members, s, tr: _first_member(members))
        monkeypatch.setattr(step_mod, "psum", lambda x, tr: x[0])
    elif fault == "altered":
        psum_tree, optcc = step_mod.psum_tree, step_mod.optcc_allreduce_tree
        monkeypatch.setattr(step_mod, "psum_tree", lambda members, tr:
                            _altered(psum_tree(members, tr)))
        monkeypatch.setattr(step_mod, "optcc_allreduce_tree",
                            lambda members, s, tr:
                            _altered(optcc(members, s, tr)))


def _plant_allreduce(monkeypatch, fault):
    psum_tree, optcc = comms.psum_tree, comms.optcc_allreduce_tree
    if fault == "no_exchange":
        def broken(members, *rest):
            return _first_member(members)
    elif fault == "half_batch":
        def broken(members, *rest):
            members = list(members)
            return [2 * a + 2 * b for a, b in zip(members[0], members[1])]
    else:
        monkeypatch.setattr(comms, "psum_tree", lambda members, tr:
                            _altered(psum_tree(members, tr)))
        monkeypatch.setattr(comms, "optcc_allreduce_tree",
                            lambda members, s, tr:
                            _altered(optcc(members, s, tr)))
        return
    monkeypatch.setattr(comms, "psum_tree", broken)
    monkeypatch.setattr(comms, "optcc_allreduce_tree", broken)


@pytest.mark.parametrize("name", TRAIN + ALLREDUCE)
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange",
                                   "altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_caught(name, fault, monkeypatch):
    _plant_train(monkeypatch, fault)
    result = _run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "no_exchange", "altered"])
@pytest.mark.parametrize("name", ALLREDUCE)
def test_allreduce_fault_is_caught(name, fault, monkeypatch):
    _plant_allreduce(monkeypatch, fault)
    result = _run(name)
    assert not result["correct"], result["checks"]
