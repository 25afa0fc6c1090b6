"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``<package>/**/csrc/*.cu`` exposes a plain C interface
and is compiled on first use into ``<checkout>/build/repro_torch/`` as
``lib<name>-<hash>.so``; the hash covers the source and the compiler flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

# name -> source, relative to the package
SOURCES = {
    "chunk_reduce": "kernels/chunk_reduce/csrc/chunk_reduce.cu",
    "flash_attention": "kernels/flash_attention/csrc/flash_attention.cu",
    "flash_prefill": "kernels/flash_attention/csrc/flash_prefill.cu",
    "flash_decode": "kernels/flash_attention/csrc/flash_decode.cu",
    "wkv": "kernels/wkv/csrc/wkv.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")   # toolkit default
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    src = _PKG / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_nvcc(src: pathlib.Path, out: pathlib.Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp   # type: ignore[attr-defined]
    return proc


def _start(name: str) -> subprocess.Popen | None:
    out = library_path(name)
    if out.exists():
        return None
    return _start_nvcc(_PKG / SOURCES[name], out)


def _finish(name: str, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)
    return log


def _finish_all(procs: dict) -> dict[str, str]:
    try:
        return {n: _finish(n, p) for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all) with one nvcc each, all
    started together; returns {name: compiler output} (``-Xptxas -v``
    register and spill report; empty when the library was already built)."""
    names = list(SOURCES if names is None else names)
    return _finish_all({n: _start(n) for n in names})


def build_files(sources: dict, out_dir: pathlib.Path) -> dict[str, str]:
    """Compile each {name: source path} with the same flags into
    ``out_dir/lib<name>.so``, one nvcc each, all started together (for
    measurement scripts that build edited or extra sources); returns
    {name: compiler output}."""
    return _finish_all({n: _start_nvcc(pathlib.Path(src),
                                       out_dir / f"lib{n}.so")
                        for n, src in sources.items()})


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")
