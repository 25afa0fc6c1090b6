"""Where a full-width checkpoint's save and restore spend their time.

    python3 tools/ckpt_io_profile.py            # qwen3-1.7b on the card
    python3 tools/ckpt_io_profile.py --smoke --device cpu   # a rehearsal

Builds the train state that `launch/train.py` trains (qwen3-1.7b, bf16
params, fp32 moments, random init from a seed) and times, once each:

  save     - `repro_torch.checkpoint.save`, as the launcher calls it;
  raw_read - arrays.npz read in 64 MiB blocks and dropped (the file
             system's rate; the file was just written, as in a restore
             that follows a save);
  npz_read - every member read into host memory with `np.load`, nothing
             copied to the device;
  d2h      - every leaf copied to pageable host memory, nothing written;
  h2d      - those host copies copied into the state's tensors;
  restore  - `repro_torch.checkpoint.restore` into the state.

Prints one JSON line per measurement (seconds, bytes, GB/s), one for the
machine (RAM, cores, the directory's free bytes) and the card's name and
power limit. The checkpoint goes to a new directory under `build/` (or
--dir), removed at the end. It writes one checkpoint (~17.2 GB).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.checkpoint import restore, save
    from repro_torch.checkpoint.ckpt import _to_host, leaves
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state

    dev = resolve_device(args.device)
    model = build_model(get_config("qwen3-1.7b", smoke=args.smoke))
    state = init_train_state(model, AdamWConfig(weight_decay=0.01),
                             device=dev)
    flat = dict(leaves(state))
    nbytes = sum(v.numel() * v.element_size() for v in flat.values()
                 if isinstance(v, torch.Tensor))
    parent = pathlib.Path(args.dir) if args.dir else ROOT / "build"
    parent.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="ckpt_io_", dir=parent)
    emit({"machine": {"cores": os.cpu_count(),
                      "ram_bytes": os.sysconf("SC_PAGE_SIZE")
                      * os.sysconf("SC_PHYS_PAGES"),
                      "dir": ckpt,
                      "dir_free_bytes": shutil.disk_usage(ckpt).free,
                      "state_bytes": nbytes}})

    def timed(name, fn, size):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        s = time.perf_counter() - t
        emit({"op": name, "seconds": s, "bytes": size, "gb_per_s":
              size / s / 1e9})
        return out

    try:
        timed("save", lambda: save(ckpt, 0, state), nbytes)
        npz = pathlib.Path(ckpt) / "step_0" / "arrays.npz"
        size = npz.stat().st_size

        def raw_read():
            with open(npz, "rb") as f:
                while f.read(1 << 26):
                    pass

        timed("raw_read", raw_read, size)

        def npz_read():
            with np.load(npz, allow_pickle=False) as z:
                return [z[k] for k in z.files]

        timed("npz_read", npz_read, nbytes)     # the arrays are dropped
        host = timed("d2h", lambda: {k: _to_host(v, copy=True) for k, v in
                                     flat.items()
                                     if isinstance(v, torch.Tensor)}, nbytes)

        @torch.no_grad()
        def h2d():
            for k, arr in host.items():
                if flat[k].dtype == torch.bfloat16:
                    flat[k].copy_(torch.from_numpy(arr.view(np.int16))
                                  .view(torch.bfloat16))
                else:
                    flat[k].copy_(torch.from_numpy(arr))

        timed("h2d", h2d, nbytes)
        host.clear()
        timed("restore", lambda: restore(ckpt, state), nbytes)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        emit({"device": torch.cuda.get_device_name(0), "smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
