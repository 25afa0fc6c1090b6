"""The benchmark's own arithmetic against counts made by hand."""
import json
import pathlib

import pytest
import torch

from bench.harness import readings, yardstick
from bench.reference import decoder

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_internlm2_flops_per_token():
    # 24 layers of (2 x 2048^2 + 2 x 2048 x 1024) attention projections and
    # 3 x 2048 x 8192 MLP, and the 2048 x 92544 head: 1,699,479,552 weights;
    # attention 12 x 16 x 128 x 512.5 a layer at S 1024
    cfg = _cfg("internlm2-1.8b")
    assert yardstick.matmul_weights_per_token(cfg) == 1_699_479_552
    got = yardstick.train_flops_per_token(cfg, 1024)
    assert got == 6 * 1_699_479_552 + 12 * 16 * 128 * 512.5 * 24
    assert got == pytest.approx(1.0499e10, rel=1e-4)


def test_phi35moe_one_layer_flops_per_token():
    # attention 2 x 4096^2 + 2 x 4096 x 1024, two experts of 3 x 4096 x 6400,
    # the router 4096 x 16 and the 4096 x 32064 head
    cfg = _cfg("phi3.5-moe-1layer")
    weights = (2 * 4096 ** 2 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 6400
               + 4096 * 16 + 4096 * 32064)
    assert yardstick.matmul_weights_per_token(cfg) == weights
    got = yardstick.train_flops_per_token(cfg, 1024)
    assert got == pytest.approx(2.009e9, rel=1e-3)


def _groups(cfg):
    groups = {}
    for shape, dt, _ in decoder.param_layout(cfg).values():
        groups[dt] = groups.get(dt, 0) + torch.Size(shape).numel()
    return groups


def test_reduction_least_bytes_of_the_cells():
    internlm2 = _groups(_cfg("internlm2-1.8b"))
    assert internlm2 == {"bfloat16": 1_889_110_016}
    # four bf16 vectors read, their sum written
    assert yardstick.reduction_least_bytes(internlm2, 4) == \
        5 * 2 * 1_889_110_016
    assert yardstick.least_seconds(5 * 2 * 1_889_110_016) == \
        pytest.approx(5.639e-3, rel=1e-3)
    phi = _groups(_cfg("phi3.5-moe-1layer"))
    assert phi == {"bfloat16": 1_562_914_816, "float32": 65_536}
    assert yardstick.reduction_least_bytes(phi, 4) == \
        5 * (2 * 1_562_914_816 + 4 * 65_536)


def test_percentile_and_roofline_readings():
    assert readings.percentile(list(range(1, 101)), 95) == 95
    assert readings.percentile([3.0], 95) == 3.0
    assert readings.percentile([], 95) is None

    class Tr:
        device = [object()]

        @staticmethod
        def device_seconds(match):
            return 0.010 if match("void chunk_reduce_kernel<bf16>") else 0.0
    run = {"trace": Tr, "least_bytes": 3.35e12 * 0.004, "traced_units": 2}
    assert readings.roofline(run, "chunk_reduce") == pytest.approx(80.0)
    assert readings.roofline({"trace": None}, "chunk_reduce") is None
