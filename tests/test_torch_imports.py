"""The port stands alone: importing every module of repro_torch and
chip_smoke.py loads no JAX and no module of the JAX package; the device
pick never falls back to the CPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke     # its main() runs only as a script
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
for mod in ("kernels.chunk_reduce.kernel", "kernels.flash_attention.kernel",
            "kernels.wkv.kernel", "models.rwkv6", "train.serve",
            "launch.serve", "configs.rwkv6_7b"):
    assert "repro_torch." + mod in names, mod
print("IMPORTED", len(names))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=_env(), timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without CUDA, or copied away from the rest of the repository, the
    chip smoke test exits nonzero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, timeout=600,
                          cwd=script.parent)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
