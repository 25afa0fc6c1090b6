"""Process groups for `ProcessTransport`: rendezvous, spawn, results.

`spawn(fn, world, args)` starts `world` processes (the spawn start
method), joins them into one gloo group through a `FileStore` in a fresh
temporary directory (no TCP port to collide on: two runs at once each have
their own), calls fn(rank, *args) in each, and returns the ranks' return
values, which each process saves into that directory. A process that
raises fails the whole run: `torch.multiprocessing.spawn`'s join ends the
others and raises. Nothing falls back to one process or to the CPU.

The children take the parent's thread count and TF32 switches, so that a
rank computes what the same member computes in one process.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch

# how long a rank waits in a collective or a receive before gloo fails it
TIMEOUT = datetime.timedelta(minutes=10)


def _settings() -> dict:
    return {"threads": torch.get_num_threads(),
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}


def _entry(rank: int, world: int, run_dir: str, fn, args: tuple,
           settings: dict) -> None:
    import torch.distributed as dist
    torch.set_num_threads(settings["threads"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    store = dist.FileStore(os.path.join(run_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(run_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = ()) -> list:
    """[fn(rank, *args) for each rank], each in its own process of a gloo
    group of `world`; fn must be importable (a module-level function) and
    return what torch.save can write."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as run_dir:
        mp.spawn(_entry, args=(world, run_dir, fn, tuple(args), _settings()),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(run_dir, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]


def rank_device(name) -> torch.device:
    """The device a rank works on, resolved as `device.resolve_device`
    does; a CUDA device gets its index (0 unless named) and becomes the
    process's current device."""
    from repro_torch.device import resolve_device
    dev = resolve_device(name)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    return dev


def imported_modules(rank: int, names=()) -> list[str]:
    """Import each module of `names`, then return the top-level modules
    this process has imported (for checks that a rank loads nothing it
    should not)."""
    import importlib
    for name in names:
        importlib.import_module(name)
    return sorted({name.split(".")[0] for name in sys.modules})
