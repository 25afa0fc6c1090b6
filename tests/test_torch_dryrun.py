"""The port's dry run (`repro_torch.launch.dryrun`) held to the JAX
package's (`repro/launch/dryrun.py`, run in one subprocess with its 512
forced host devices): each cell's `info` and `model_flops` equal for all
applicable (arch, shape) cells on both production meshes, and the skip
reasons equal; a train cell's count (one microbatch times nm, AdamW once)
against a trace of the whole step; the CLI's records and their report."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell,  # noqa: E402
                                 cell_is_applicable, get_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (input_specs,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.shardctx import get_batch_axes  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.roofline import analyze_program, report  # noqa: E402
from repro_torch.sharding import Mesh  # noqa: E402
from repro_torch.train import TrainState, make_gspmd_train_step  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
MESHES = ("single", "multi")

_JAX_CELLS = r"""
import json, sys
from repro.launch import dryrun   # sets the 512 forced host devices first
from repro.configs import ARCH_IDS, SHAPES, cell_is_applicable
from repro.launch.mesh import make_production_mesh
out = {}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for arch in ARCH_IDS:
        for shape in SHAPES:
            key = f"{arch}|{shape.name}|{kind}"
            ok, why = cell_is_applicable(arch, shape)
            if not ok:
                out[key] = {"skipped": why}
                continue
            _, _, model_flops, info = dryrun.build_cell_program(
                arch, shape, mesh)
            out[key] = {"model_flops": model_flops, "info": {
                k: v if isinstance(v, int) else float(v)
                for k, v in info.items()}}
json.dump({"cells": out, "microbatches": dryrun.TRAIN_MICROBATCHES,
           "remat": dryrun.TRAIN_REMAT_DEFAULT}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jax_cells.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_CELLS, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(out.read_text())


def _cells():
    return [(arch, shape, kind) for kind in MESHES for arch in ARCH_IDS
            for shape in SHAPES]


def test_cell_info_and_model_flops_equal_jax(jax_cells):
    """Every (arch, shape, mesh) cell: the skip reason of the inapplicable
    ones, and `info` (parameter counts; per-device bytes of the
    parameters, AdamW state and decode cache by the sharding rules) and
    `model_flops` of the applicable ones, equal to JAX's."""
    assert dryrun.TRAIN_MICROBATCHES == jax_cells["microbatches"]
    assert dryrun.TRAIN_REMAT_DEFAULT == jax_cells["remat"]
    applicable = 0
    for arch, shape, kind in _cells():
        want = jax_cells["cells"][f"{arch}|{shape.name}|{kind}"]
        ok, why = cell_is_applicable(arch, shape)
        if not ok:
            assert want == {"skipped": why}
            continue
        applicable += 1
        mesh = make_production_mesh(multi_pod=kind == "multi")
        program, model_flops, info = dryrun.build_cell_program(
            arch, shape, mesh)
        got = json.loads(json.dumps({"model_flops": model_flops,
                                     "info": info}))
        assert got == want, (arch, shape.name, kind)
        assert program["kind"] == shape.kind
    assert applicable == 66


def test_one_microbatch_times_nm_equals_the_whole_step():
    """qwen3-smoke, 8 x 32 tokens as 4 microbatches: the dry run's count
    (one microbatch's loss, gradients and accumulation, times 4, then
    AdamW) against a trace of make_gspmd_train_step itself. FLOPs and every
    dot op's calls are equal; the step's bytes exceed the count by exactly
    the accumulators' zeroing (4 bytes a parameter) and final division
    (8), plus the loss's scalar ops."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    cell = ShapeCell("train_smoke", 32, 8, "train")
    inputs = tuple((k, tuple(v.shape), v.dtype) for k, v in input_specs(
        "qwen3-1.7b", cell, make_production_mesh(), cfg).items())
    est = dryrun.train_counts(cfg, inputs, 4)
    model = build_model(cfg)
    params = dryrun.meta_params(cfg)
    opt_cfg = AdamWConfig()
    state = TrainState(params, init_state(params, opt_cfg), 0)
    step = make_gspmd_train_step(model, Mesh((1, 1), ("data", "model")),
                                 opt_cfg, constant(1e-4),
                                 num_microbatches=4)
    whole, _ = analyze_program(step, state, dryrun.meta_batch(inputs, 8))
    assert est.flops == whole.flops > 0
    for op in ("aten.mm", "aten.bmm", "aten.addmm"):
        assert est.op_counts.get(op) == whole.op_counts.get(op), op
    n = sum(p.numel() for p in params.values())
    assert 0 <= whole.hbm_bytes - est.hbm_bytes - 12 * n <= 256
    assert est.peak_live_bytes == pytest.approx(whole.peak_live_bytes,
                                                rel=0.01)


def test_train_cell_counts_scale_with_microbatches():
    cfg = get_config("qwen3-1.7b", smoke=True)
    inputs = (("tokens", (8, 32), torch.int32),
              ("labels", (8, 32), torch.int32))
    one = dryrun.train_counts(cfg, inputs, 1)
    two = dryrun.train_counts(cfg, inputs, 2)
    assert one.flops == two.flops         # the same tokens, split in two
    assert two.op_counts["aten.mm"] == 2 * (one.op_counts["aten.mm"])
    with pytest.raises(ValueError, match="microbatches"):
        dryrun.train_counts(cfg, inputs, 3)


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """The CLI on qwen3-1.7b's cells, both meshes, cut to one layer."""
    out = tmp_path_factory.mktemp("records")
    old = dryrun.OUT_DIR
    dryrun.OUT_DIR = out
    try:
        dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "both", "--force",
                     "--set", "n_layers=1"])
        dryrun.main(["--arch", "rwkv6-7b", "--shape", "prefill_32k",
                     "--set", "n_layers=1"])
    finally:
        dryrun.OUT_DIR = old
    return out


def _rec(out, arch, shape, mesh):
    return json.loads((out / f"{arch}__{shape}__{mesh}__baseline.json")
                      .read_text())


def test_cli_record_keys(cli_records):
    keys = {"arch", "shape", "mesh", "tag", "timestamp", "status", "chips",
            "per_device", "memory_analysis", "collectives",
            "collectives_reason", "op_count", "roofline", "info", "timings",
            "overrides"}
    for mesh, chips in (("single", 256), ("multi", 512)):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            rec = _rec(cli_records, "qwen3-1.7b", shape, mesh)
            assert rec["status"] == "ok", rec.get("traceback")
            assert set(rec) == keys | ({"pos"} if shape == "decode_32k"
                                       else set())
            assert rec["chips"] == chips and rec["collectives"] is None
            assert rec["per_device"] == "even split"
            assert rec["overrides"] == {"n_layers": "1"}
            r = rec["roofline"]
            assert r["collective_bytes_per_device"] is None
            assert r["flops_per_device"] * chips == rec["op_count"]["flops"]
            top = rec["op_count"]["top_flop_ops"]
            assert [f for f, _, _ in top] == sorted(
                (f for f, _, _ in top), reverse=True)
            assert sum(f for f, _, _ in top) == rec["op_count"]["flops"]
            assert rec["memory_analysis"]["peak_live_bytes"] > 0
            assert set(rec["timings"]) == {"trace_s", "trace_reused"}
            assert rec["timings"]["trace_reused"] == (mesh == "multi")
            cfg = get_config("qwen3-1.7b").replace(n_layers=1)
            cell = next(c for c in SHAPES if c.name == shape)
            assert rec["info"] == json.loads(json.dumps(
                dryrun.build_cell_program(
                    "qwen3-1.7b", cell,
                    make_production_mesh(multi_pod=mesh == "multi"),
                    cfg)[2]))
        skipped = _rec(cli_records, "qwen3-1.7b", "long_500k", mesh)
        assert skipped["status"] == "skipped" and skipped["reason"]
    decode = _rec(cli_records, "qwen3-1.7b", "decode_32k", "single")
    assert decode["pos"] == 32767
    assert decode["op_count"]["ops"]["flash_decode"] == 1
    prefill = _rec(cli_records, "qwen3-1.7b", "prefill_32k", "single")
    assert prefill["op_count"]["ops"]["flash_prefill"] == 1
    assert prefill["roofline"]["model_flops"] == \
        2.0 * prefill["info"]["n_active"] * 32 * 32768
    assert _rec(cli_records, "rwkv6-7b", "prefill_32k",
                "single")["op_count"]["ops"]["wkv"] == 1
    assert get_batch_axes() is None       # set around each cell only


def test_cli_keeps_a_record_unless_forced(cli_records, capsys):
    old = dryrun.OUT_DIR
    dryrun.OUT_DIR = cli_records
    try:
        before = _rec(cli_records, "qwen3-1.7b", "decode_32k", "single")
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k"])
        assert _rec(cli_records, "qwen3-1.7b", "decode_32k",
                    "single") == before
    finally:
        dryrun.OUT_DIR = old
    assert "[single] qwen3-1.7b x decode_32k: ok" in capsys.readouterr().out


def test_report_renders_the_records(cli_records, capsys):
    t = report.table("single", out_dir=cli_records)
    lines = t.splitlines()
    assert lines[0].startswith("| arch | shape | status")
    rows = [ln for ln in lines[2:] if ln.startswith("| qwen3-1.7b")]
    assert len(rows) == 4
    assert any("| skipped |" in ln for ln in rows)
    train = next(ln for ln in rows if "| train_4k |" in ln)
    assert "| ok |" in train and "| - |" in train    # no collective term
    m = report.memory_table("multi", out_dir=cli_records)
    assert "| qwen3-1.7b | decode_32k |" in m and "cache/dev" in m
    old = dryrun.OUT_DIR
    dryrun.OUT_DIR = cli_records
    try:
        report.main(["--mesh", "multi", "--memory"])
    finally:
        dryrun.OUT_DIR = old
    assert "| qwen3-1.7b | train_4k |" in capsys.readouterr().out
