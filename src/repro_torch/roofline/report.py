"""Render the roofline table from the port's dry-run records (the port of
`repro/roofline/report.py`).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single]
       [--tag baseline] [--memory]
Prints a markdown table of the dry run's records (experiments/
dryrun_torch/). The port's records count no collectives (no SPMD
partitioner): those columns read "-".
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch import dryrun


def load(mesh: str, tag: str = "baseline", out_dir=None) -> list[dict]:
    """The records of `mesh` and `tag` in out_dir (the dry run's)."""
    recs = []
    for f in sorted(pathlib.Path(out_dir or dryrun.OUT_DIR).glob(
            f"*__{mesh}__{tag}.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def one_liner(rec) -> str:
    """What would move the dominant term down - rule-based suggestion."""
    if rec["status"] != "ok":
        return ""
    r = rec["roofline"]
    dom = r["dominant"]
    shape = rec["shape"]
    arch = rec["arch"]
    if dom == "memory" and shape.startswith("train"):
        if arch.startswith("rwkv"):
            return ("wkv state round-trips dominate; training takes the "
                    "scan, the wkv kernel keeps the state on chip")
        return ("unfused eager ops dominate (every op reads and writes "
                "HBM); fuse, flash-attention backward")
    if dom == "memory" and "decode" in shape or "long" in shape:
        return "KV-cache reads dominate (expected for decode); quantize KV"
    if dom == "memory":
        return "activation streaming; fuse the eager ops"
    if dom == "collective":
        return "resharding traffic; fewer FSDP gathers or bigger microbatch"
    return "compute-bound: good; raise per-chip batch or quantize"


def table(mesh: str, tag: str = "baseline", out_dir=None) -> str:
    rows = [
        "| arch | shape | status | t_comp (s) | t_mem (s) | t_coll (s) | "
        "dominant | useful-FLOPs | roofline-frac | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load(mesh, tag, out_dir):
        if rec["status"] == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | skipped | - | - | - | "
                f"- | - | - | {rec['reason']} |")
            continue
        if rec["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | ERROR | "
                        f"- | - | - | - | - | - | {rec.get('error','')} |")
            continue
        r = rec["roofline"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | ok "
            f"| {r['t_compute_s']:.3g} | {r['t_memory_s']:.3g} "
            f"| - | {r['dominant']} "
            f"| {r['useful_flops_fraction']:.2f} "
            f"| {r['roofline_fraction']:.2e} | {one_liner(rec)} |")
    return "\n".join(rows)


def memory_table(mesh: str, tag: str = "baseline", out_dir=None) -> str:
    rows = ["| arch | shape | params/dev | opt/dev | cache/dev | "
            "flops/dev | coll bytes/dev | dominant coll | peak live (global) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for rec in load(mesh, tag, out_dir):
        if rec["status"] != "ok":
            continue
        info = rec["info"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} "
            f"| {fmt_bytes(info.get('params_bytes_per_device', 0))} "
            f"| {fmt_bytes(info.get('opt_bytes_per_device', 0))} "
            f"| {fmt_bytes(info.get('cache_bytes_per_device', 0))} "
            f"| {rec['roofline']['flops_per_device']:.2e} | - | - "
            f"| {fmt_bytes(rec['memory_analysis']['peak_live_bytes'])} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.roofline.report")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--memory", action="store_true")
    args = ap.parse_args(argv)
    if args.memory:
        print(memory_table(args.mesh, args.tag))
    else:
        print(table(args.mesh, args.tag))


if __name__ == "__main__":
    main()
