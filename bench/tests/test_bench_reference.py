"""The plain references against the program at small sizes: one checked
training run of each training cell's kind, one AllReduce of each kind.
In float32 the two sides differ by rounding alone."""
import time

import pytest
import torch

from bench.harness.drivers import allreduce, train
from bench.reference import allreduce as ref_allreduce
from bench_cells import ALLREDUCE, TRAIN, small_spec

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device(name)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cell", TRAIN)
def test_train_step_matches_reference(cell, device):
    run = train.run(small_spec(cell), 11, 0.0, False, _device(device),
                    lambda obj: None, time.perf_counter())
    v = run["values"]
    assert v["loss"] < 1e-5 and v["first_grad"] < 1e-5, v
    assert v["first_grad_dir"] < 1e-4, v
    assert v["param_change"] < 1e-4, v
    assert run["units"] == 1 and run["failed"] == 0


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cell", ALLREDUCE)
def test_allreduce_matches_exact_sum(cell, device):
    spec = small_spec(cell)
    spec.traffic["grad_dtype"] = "bfloat16"
    run = allreduce.run(spec, 12, 0.0, False, _device(device),
                        lambda obj: None, time.perf_counter())
    assert run["values"]["max_err_ulp"] <= 0.5


def test_err_ulp_of_a_sum():
    members = [torch.tensor([1.0, 3.0, 0.5], dtype=torch.bfloat16),
               torch.tensor([1.0, -3.0, 0.25], dtype=torch.bfloat16)]
    exact = torch.tensor([2.0, 0.0, 0.75], dtype=torch.bfloat16)
    assert ref_allreduce.max_err_ulp(exact, members) == 0.0
    off = exact.clone()
    off[0] = 2.015625                       # one bf16 ulp above 2
    assert ref_allreduce.max_err_ulp(off, members) == 1.0
    # where the members cancel, the ulp is taken at 2^-8 x 3
    # (in [2^-7, 2^-6), where the bf16 ulp is 2^-14)
    residue = torch.tensor([2.0, 2.0 ** -14, 0.75], dtype=torch.bfloat16)
    assert ref_allreduce.max_err_ulp(residue, members) == 1.0
