"""The control of each cell, at a size a test run holds: the plain
reference put in the program's place at the precision below the one the
configuration states has to fail one of the cell's numbers, in the
cell's own dtypes (on the chip the same control runs at the cell's own
size: `bench/calibrate.py`)."""
import pytest
import torch

from bench.harness import checks, inputs
from bench.harness.drivers import train
from bench.reference import allreduce as ref_allreduce
from bench.reference import decoder
from bench_cells import ALLREDUCE, TRAIN, small_spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [31, 32, 33])
@pytest.mark.parametrize("name", TRAIN)
def test_fp8_control_fails_a_train_number(name, seed):
    spec = small_spec(name, "bfloat16")
    ref, _ = train.reference(spec.config, spec.traffic, seed, CPU)
    ctl, _ = train.reference(spec.config, spec.traffic, seed, CPU,
                             control="fp8")
    got = checks.train_values(ctl, ref)
    assert any(got[k] > lim for k, lim in spec.limits.items()), got


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_fp8_operands_control_fails_the_dense_train_cell(seed):
    """The second control, fp8 operands of the linear layers alone, is
    separated in the dense cell only: in the MoE cell the program's own
    routing flips read as far from the float32 reference (PERF.md)."""
    spec = small_spec("internlm2-train-degraded", "bfloat16")
    ref, _ = train.reference(spec.config, spec.traffic, seed, CPU)
    ctl, _ = train.reference(spec.config, spec.traffic, seed, CPU,
                             control="fp8_operands")
    got = checks.train_values(ctl, ref)
    assert any(got[k] > lim for k, lim in spec.limits.items()), got


@pytest.mark.parametrize("seed", [31, 32, 33])
@pytest.mark.parametrize("name", ALLREDUCE)
def test_bf16_accumulation_fails_the_allreduce(name, seed):
    spec = small_spec(name)
    tr = spec.traffic
    layout = decoder.param_layout(spec.config)
    _, members = inputs.member_grads(layout, seed, tr["dp"],
                                     tr["grad_dtype"], tr["grad_scale"], CPU)
    worst = max(ref_allreduce.max_err_ulp(
        ref_allreduce.sum_bf16([m[k].reshape(-1) for m in members]),
        [m[k].reshape(-1) for m in members]) for k in range(len(layout)))
    assert worst > spec.limits["max_err_ulp"]
