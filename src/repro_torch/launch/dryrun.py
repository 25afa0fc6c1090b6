"""The dry run (the port of `repro/launch/dryrun.py`): every (arch x shape x
mesh) cell's program counted, nothing allocated.

JAX lowers and compiles each cell against ShapeDtypeStruct stand-ins
carrying the production shardings and reads memory_analysis,
cost_analysis and the HLO. The port has no SPMD partitioner and no HLO, so
for each cell it:

  * takes `info` (parameter counts, per-device bytes of the parameters,
    optimizer state and decode cache) and `model_flops` from the sharding
    rules on the production mesh's description (`shardings_for_params`,
    `launch.mesh.input_specs`, `cache_specs`): JAX's numbers, held equal
    to them (tests/test_torch_dryrun.py);
  * runs the global program once on `meta` tensors under
    `roofline.op_count` (FLOPs, bytes, ops, peak live bytes), on a
    one-device mesh (`make_gspmd_train_step` refuses more): a train cell
    as one microbatch's loss and gradients (added into fp32 accumulators
    when there are several), counted nm times, and AdamW once; a prefill
    cell as `prefill`; a decode cell as one `decode_step` at the last
    position of a full cache. A kernel on the path (flash attention, wkv)
    records its work there, as on the card it would run;
  * splits the global counts evenly over the mesh's chips
    (`"per_device": "even split"`) and leaves the collectives unknown
    (`"collectives": null`).

A trace is kept per (config, shape, microbatches) for the run, so a cell's
second mesh reuses it. Records go to experiments/dryrun_torch/, one JSON
file per cell, which `repro_torch.roofline.report` renders.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh single [--tag baseline] [--force] [--set remat=dots] ...
  python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell,
                                 cell_is_applicable, get_config,
                                 parse_overrides)
from repro_torch.launch.mesh import (batch_axes, cache_specs, input_specs,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models.shardctx import set_batch_axes
from repro_torch.optim import AdamWConfig, update
from repro_torch.optim.schedules import constant
from repro_torch.roofline import Roofline
from repro_torch.roofline.op_count import (analyze_program, combined, scaled,
                                           top_flop_ops)
from repro_torch.sharding import ShapeDtypeStruct, eval_shape
from repro_torch.train import shardings_for_params

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# the JAX dry run's microbatch counts for train_4k
TRAIN_MICROBATCHES = {
    "gemma3-27b": 8, "arctic-480b": 8, "phi3.5-moe-42b-a6.6b": 4,
    "rwkv6-7b": 4, "qwen3-1.7b": 2, "minicpm-2b": 2, "internlm2-1.8b": 2,
    "hymba-1.5b": 2, "whisper-base": 1, "qwen2-vl-2b": 2,
}

# the JAX dry run's remat policy for dense, moe and vlm train cells;
# --set remat=none gives the unrematted variant
TRAIN_REMAT_DEFAULT = "full"

COLLECTIVES_UNKNOWN = ("the port has no SPMD partitioner: the cell is "
                       "counted as one global program")


@functools.lru_cache(maxsize=None)
def _param_template(cfg) -> dict:
    """{path: (shape, dtype)} of cfg's parameters, from its init on fake
    tensors (a full arctic-480b is ~953 GB)."""
    shapes = eval_shape(build_model(cfg).init, 0, device="cpu")
    return {k: (tuple(v.shape), v.dtype) for k, v in shapes.items()}


def _shard_count(sharding) -> int:
    if sharding is None:
        return 1
    return math.prod(sharding.mesh.shape[a] for axes in sharding.spec
                     if axes for a in ((axes,) if isinstance(axes, str)
                                       else axes))


def _bytes_per_device(sds: dict) -> float:
    """JAX's _tree_bytes_per_device over a {path: ShapeDtypeStruct}."""
    total = 0.0
    for leaf in sds.values():
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        total += nbytes / _shard_count(leaf.sharding)
    return total


def build_cell_program(arch: str, shape: ShapeCell, mesh, cfg=None,
                       microbatches=None):
    """Returns (program, model_flops, info): info and model_flops are the
    JAX dry run's; `program` describes the cell's global program for
    `count_cell`: its kind, config, model inputs (`input_specs`' shapes
    and dtypes), microbatches, and a decode cache's batch and length."""
    cfg = cfg or get_config(arch)
    B, S = shape.global_batch, shape.seq_len
    template = _param_template(cfg)
    pshard = shardings_for_params(
        {k: ShapeDtypeStruct(s, d) for k, (s, d) in template.items()}, cfg,
        mesh)
    params_sds = {k: ShapeDtypeStruct(s, d, pshard[k])
                  for k, (s, d) in template.items()}
    n_params = sum(math.prod(s) for s, _ in template.values())
    n_active = cfg.active_params if cfg.family == "moe" else n_params
    info = {"n_params": n_params, "n_active": n_active,
            "params_bytes_per_device": _bytes_per_device(params_sds)}
    inputs = tuple((k, tuple(v.shape), v.dtype) for k, v in
                   input_specs(arch, shape, mesh, cfg).items())
    program = {"kind": shape.kind, "cfg": cfg, "inputs": inputs, "nm": 1,
               "cache": None}
    if shape.kind == "train":
        nm = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        mdt = getattr(torch, cfg.moment_dtype)
        moments = {k: ShapeDtypeStruct(s.shape, mdt, s.sharding)
                   for k, s in params_sds.items()}
        info["opt_bytes_per_device"] = 2 * _bytes_per_device(moments) \
            + _bytes_per_device({"count": ShapeDtypeStruct((), torch.int32)})
        info["microbatches"] = nm
        program["nm"] = nm
        return program, 6.0 * n_active * B * S, info
    if shape.kind == "prefill":
        return program, 2.0 * n_active * B * S, info
    info["cache_bytes_per_device"] = _bytes_per_device(
        cache_specs(cfg, mesh, B, S))
    program["cache"] = (B, S)
    return program, 2.0 * n_active * B * 1, info


def _meta(shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def meta_params(cfg, grad: bool = False) -> dict:
    """cfg's parameters as empty `meta` tensors."""
    return {k: _meta(s, d, grad) for k, (s, d) in
            _param_template(cfg).items()}


def meta_batch(inputs, rows: int) -> dict:
    """Model inputs on `meta` from (name, shape, dtype) triples, with
    `rows` rows: token ids in the port's int64, the rest as specified."""
    return {k: _meta((rows,) + shape[1:],
                     torch.int64 if dtype == torch.int32 else dtype)
            for k, shape, dtype in inputs}


def train_counts(cfg, inputs, nm: int):
    """A train step over the batch `inputs` describes, in nm microbatches,
    counted as one microbatch's loss and gradients (added into fp32
    accumulators when nm > 1, as `make_gspmd_train_step` does) times nm,
    then AdamW once. The accumulators' zeroing and final division are not
    counted."""
    model = build_model(cfg)
    opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
    params = meta_params(cfg, grad=True)
    mdt = getattr(torch, opt_cfg.moment_dtype)
    opt = {"mu": {k: _meta(p.shape, mdt) for k, p in params.items()},
           "nu": {k: _meta(p.shape, mdt) for k, p in params.items()},
           "count": _meta((), torch.int32)}
    rows = inputs[0][1][0]
    if rows % nm:
        raise ValueError(f"batch of {rows} rows does not split into {nm} "
                         "microbatches")
    mb = meta_batch(inputs, rows // nm)
    acc = ({k: _meta(p.shape, torch.float32) for k, p in params.items()}
           if nm > 1 else None)

    def microbatch(params, opt, acc, mb):
        leaves = list(params.values())
        grads = torch.autograd.grad(model.loss(params, mb), leaves)
        if acc is None:
            return dict(zip(params, grads))
        for a, g in zip(acc.values(), grads):
            a.add_(g)
        return acc

    grad_count, grads = analyze_program(microbatch, params, opt, acc, mb)
    del mb
    upd_count, _ = analyze_program(
        lambda p, g, o: update(p, g, o, constant(1e-4)(0), opt_cfg), params,
        grads, opt)
    return combined(scaled(grad_count, nm), upd_count)


def serve_counts(cfg, inputs, kind: str, cache=None):
    """`prefill` of the prompts `inputs` describes, or one `decode_step` at
    position S - 1 of a full cache of (B, S) = `cache`, without autograd."""
    model = build_model(cfg)
    params = meta_params(cfg)
    with torch.no_grad():
        if kind == "prefill":
            batch = meta_batch(inputs, inputs[0][1][0])
            count, _ = analyze_program(model.prefill, params, batch)
        else:
            B, S = cache
            count, _ = analyze_program(
                model.decode_step, params, model.init_cache(B, S, "meta"),
                _meta((B, 1), torch.int64), S - 1)
    return count


_COUNTS: dict = {}      # a program's key -> (OpAnalysis, seconds)


def count_cell(program: dict):
    """(OpAnalysis, trace seconds, reused) of a cell's global program,
    traced once per run."""
    key = tuple(program[k] for k in ("kind", "cfg", "inputs", "nm", "cache"))
    if key in _COUNTS:
        return (*_COUNTS[key], True)
    t0 = time.perf_counter()
    if program["kind"] == "train":
        count = train_counts(program["cfg"], program["inputs"],
                             program["nm"])
    else:
        count = serve_counts(program["cfg"], program["inputs"],
                             program["kind"], program["cache"])
    _COUNTS[key] = (count, time.perf_counter() - t0)
    return (*_COUNTS[key], False)


def run_cell(arch: str, shape: ShapeCell, mesh_kind: str, tag="baseline",
             force=False, overrides=None, microbatches=None,
             out_dir=None) -> dict:
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_path = out_dir / f"{arch}__{shape.name}__{mesh_kind}__{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    out_dir.mkdir(parents=True, exist_ok=True)

    ok, why = cell_is_applicable(arch, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "tag": tag, "timestamp": time.time()}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    cfg = get_config(arch)
    if shape.kind == "train" and cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.replace(remat=TRAIN_REMAT_DEFAULT)
    if overrides:
        cfg = cfg.replace(**overrides)
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    set_batch_axes(batch_axes(mesh))
    try:
        program, model_flops, info = build_cell_program(
            arch, shape, mesh, cfg, microbatches)
        count, trace_s, reused = count_cell(program)
        roof = Roofline(flops=count.flops / chips,
                        bytes_hbm=count.hbm_bytes / chips,
                        bytes_collective=None, model_flops=model_flops,
                        chips=chips)
        rec.update({
            "status": "ok",
            "chips": chips,
            "per_device": "even split",
            "memory_analysis": {
                "peak_live_bytes": count.peak_live_bytes,
                "of": "the global program on one device"},
            "collectives": None,
            "collectives_reason": COLLECTIVES_UNKNOWN,
            "op_count": {
                "flops": count.flops, "hbm_bytes": count.hbm_bytes,
                "ops": count.op_counts,
                "top_flop_ops": [[f, op, n] for f, op, n in
                                 top_flop_ops(count, 10)],
                "warnings": count.warnings},
            "roofline": roof.to_dict(),
            "info": info,
            "timings": {"trace_s": trace_s, "trace_reused": reused},
        })
        if shape.kind == "decode":
            rec["pos"] = shape.seq_len - 1
    except Exception as e:
        rec.update({"status": "error", "error": repr(e),
                    "traceback": traceback.format_exc()[-4000:]})
    finally:
        set_batch_axes(None)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (hillclimbing)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPES if (args.all or not args.shape) else \
        [s for s in SHAPES if s.name == args.shape]

    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind, tag=args.tag,
                               force=args.force,
                               overrides=overrides or None,
                               microbatches=args.microbatches)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"tc={r['t_compute_s']:.3e} "
                             f"tm={r['t_memory_s']:.3e} tcoll=-")
                elif status == "error":
                    extra = rec.get("error", "")[:120]
                print(f"[{mesh_kind}] {arch} x {shape.name}: {status} "
                      f"({time.time() - t0:.1f}s) {extra}", flush=True)


if __name__ == "__main__":
    main()
