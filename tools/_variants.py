"""What the kernel-variant scripts under tools/ share: edited copies of a
kernel source, the card's name and power limit, and timing by CUDA events.
Imported by those scripts (they run as `python3 tools/<script>.py`, so this
directory is on the path); nothing here touches the card at import.
"""
from __future__ import annotations

import json
import pathlib
import subprocess


def write_edits(src: pathlib.Path, edits: dict, out_dir: pathlib.Path,
                prefix: str = "") -> dict[str, pathlib.Path]:
    """For each {variant: [(text, replacement), ...]} write `src` with
    those replacements to out_dir/<prefix><variant>.cu; returns {prefix +
    variant: path}. Exits if a text is not in the source, so an edit that
    no longer applies is not timed as if it did."""
    text = src.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, pairs in edits.items():
        body = text
        for old, new in pairs:
            if old not in body:
                raise SystemExit(f"{name}: {old!r} not in {src.name}")
            body = body.replace(old, new)
        paths[prefix + name] = out_dir / f"{prefix}{name}.cu"
        paths[prefix + name].write_text(body)
    return paths


def print_card(torch) -> None:
    """One JSON line: the card's name, and its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi}),
          flush=True)


def event_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """ms per call of `fn` by CUDA events over `iters` back-to-back calls
    after `warmup` calls (host work between launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
