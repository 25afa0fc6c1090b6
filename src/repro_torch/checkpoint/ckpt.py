"""Checkpoint/restart in the JAX package's on-disk format (the port of
`repro/checkpoint/ckpt.py`): a checkpoint written by either package
restores in the other, bit for bit.

Layout: <dir>/step_<N>/arrays.npz + meta.msgpack, written to
<dir>/.tmp_step_<N> and renamed, so a crash mid-save never corrupts the
latest checkpoint; `latest_step` counts only directories that hold both
files. meta.msgpack is {"step": N, "__dtypes__": {key: dtype}, **meta}.

Keys are the "/"-joined pytree paths of JAX's flatten order: a TrainState
is its children 0 (params), 1 (opt_state: count, mu, nu) and 2 (step, a
Python int here, stored as 0-dim int32); a dict's keys are sorted, a "/"
in a key (the port's flat parameter dicts) read as one more level.
bfloat16 leaves are stored as their uint16 bits with "bfloat16" in
`__dtypes__`, as JAX writes them, so neither side needs `ml_dtypes`.

Restore copies each stored array into the template's own tensor, one npz
member at a time, so no second copy of the state is held on the device or
the host. A synchronous save also goes one leaf at a time (host memory:
the largest leaf); an asynchronous one copies every leaf to host memory
before its thread starts, since the port's AdamW updates the state in
place while the thread writes.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import threading
import zipfile
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.train.state import TrainState

# the dtypes a leaf may have, besides bfloat16, and their names in __dtypes__
_NUMPY = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.int64: "int64",
          torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}


def _children(tree) -> Optional[list]:
    """[(path segment, child)] in JAX's flatten order, or None for a
    leaf."""
    if isinstance(tree, TrainState):
        return [("0", tree.params), ("1", tree.opt_state), ("2", tree.step)]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree, key=lambda k: k.split("/"))]
    if isinstance(tree, torch.Tensor) or (isinstance(tree, int)
                                          and not isinstance(tree, bool)):
        return None
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def leaves(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(key, leaf) pairs of `tree` in JAX's flatten order; a leaf is a
    tensor or a Python int."""
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for name, child in children:
        yield from leaves(child, f"{prefix}/{name}" if prefix else name)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, int):
        if not -2 ** 31 <= leaf < 2 ** 31:
            raise ValueError(f"int leaf {leaf} does not fit in int32")
        return "int32"
    if leaf.dtype == torch.bfloat16:
        return "bfloat16"
    if leaf.dtype not in _NUMPY:
        raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor")
    return _NUMPY[leaf.dtype]


def _to_host(leaf, copy: bool) -> np.ndarray:
    """The array stored for `leaf`: bfloat16 as its uint16 bits. With
    `copy`, never memory that the leaf shares."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    t = leaf.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.to("cpu", copy=copy).numpy()
    return arr.view(np.uint16) if leaf.dtype == torch.bfloat16 else arr


def _write_npz(path: pathlib.Path, members) -> None:
    """np.savez's format, one (key, array) member at a time."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in members:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def save(ckpt_dir: str | pathlib.Path, step: int, tree,
         meta: Optional[dict] = None,
         async_: bool = False) -> threading.Thread | None:
    """Atomically write the checkpoint of `step`. With `async_`, every leaf
    is copied to host memory first and the files are written by the
    returned thread; join it before relying on the checkpoint."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = list(leaves(tree))
    dtypes = {k: _dtype_name(v) for k, v in flat}
    meta_bytes = _msgpack.encode({"step": step, "__dtypes__": dtypes,
                                  **(meta or {})})
    if async_:   # the snapshot: device -> host happens now
        members = [(k, _to_host(v, copy=True)) for k, v in flat]
    else:
        members = ((k, _to_host(v, copy=False)) for k, v in flat)

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _write_npz(tmp / "arrays.npz", members)
        (tmp / "meta.msgpack").write_bytes(meta_bytes)
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "meta.msgpack").exists() \
                and (d / "arrays.npz").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _stored(npz, key: str, dtypes: dict) -> torch.Tensor:
    """The checkpoint's array `key` as a CPU tensor of its true dtype."""
    if key not in npz.files:
        raise KeyError(f"checkpoint missing array {key}")
    arr = npz[key]
    want = dtypes.get(key, str(arr.dtype))
    if want == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if want != str(arr.dtype) or want not in _NUMPY.values():
        raise TypeError(f"array {key}: stored dtype {want} is not one the "
                        "port restores")
    return torch.from_numpy(arr)


@torch.no_grad()
def _fill(template, key: str, npz, dtypes: dict):
    children = _children(template)
    if children is not None:
        out = {name: _fill(child, f"{key}/{name}" if key else name, npz,
                           dtypes) for name, child in children}
        if isinstance(template, TrainState):
            return TrainState(out["0"], out["1"], out["2"])
        return {k: out[k] for k in template}    # the template's own order
    src = _stored(npz, key, dtypes)
    shape = () if isinstance(template, int) else tuple(template.shape)
    if tuple(src.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: ckpt "
                         f"{tuple(src.shape)} vs template {shape}")
    if isinstance(template, int):
        return int(src)
    return template.copy_(src)          # cast to the template's dtype


def restore(ckpt_dir: str | pathlib.Path, template,
            step: Optional[int] = None) -> tuple[Any, dict]:
    """Restore the checkpoint of `step` (default: the latest) into
    `template`, in place; returns (tree, meta). The tree has the template's
    structure and its tensors, holding the stored values cast to their
    dtypes; a Python int leaf comes back as a new int. Arrays the template
    lacks are ignored; one it needs and the checkpoint lacks raises
    KeyError, a shape that differs ValueError."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    meta = _msgpack.decode((d / "meta.msgpack").read_bytes())
    dtypes = meta.pop("__dtypes__", {})
    with np.load(d / "arrays.npz", allow_pickle=False) as npz:
        tree = _fill(template, "", npz, dtypes)
    return tree, meta
