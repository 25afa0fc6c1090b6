"""The port stands alone: importing every module of repro_torch and
chip_smoke.py, in this process or in the ranks of a gloo run, loads no JAX
and no module of the JAX package; the device pick never falls back to the
CPU."""
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
            "launch.serve", "configs.rwkv6_7b", "configs.gemma3_27b",
            "configs.internlm2_1p8b", "configs.minicpm_2b",
            "configs.qwen2_vl_2b", "configs.hymba_1p5b",
            "configs.whisper_base", "models.hymba", "models.whisper",
            "configs.phi35_moe", "configs.arctic_480b", "models.moe",
            "checkpoint.ckpt",
            "checkpoint._msgpack", "comms.transport", "comms.dist",
            "comms.parity", "sharding", "models.shardctx", "launch.mesh",
            "train.step", "core.ring", "core.schedule", "core.schedule_vec",
            "core.topologies", "core.baselines", "core.registry",
            "core.flowvec", "core.simulator", "core.executor", "obs",
            "obs.telemetry", "obs.critical_path", "obs.trace", "detect",
            "detect.detector", "detect.controller", "sweeps",
            "sweeps.__main__", "sweeps.artifact", "sweeps.cli",
            "sweeps.engine", "sweeps.scenarios", "sweeps.stats", "roofline",
            "roofline.analysis", "roofline.op_count", "roofline.report",
            "launch.dryrun"):
    assert "repro_torch." + mod in names, mod
from repro_torch.train import (batch_spec, make_gspmd_train_step,
                               param_pspec, shardings_for_params)
from repro_torch.configs import SHAPES, cell_is_applicable
from repro_torch.launch.mesh import cache_specs, input_specs
from repro_torch.models.shardctx import constrain_batch
from repro_torch.core import BandwidthProfile, make_plan, simulate
from repro_torch.core.model import FaultTimeline
from repro_torch.core.planner import replay
from repro_torch.detect import ControllerConfig, DetectorConfig
prof = BandwidthProfile.single_straggler(8, 2.0, 3)
res = simulate(make_plan(prof, 1001, 4).schedule, telemetry=True)
assert res.telemetry is not None
tl = FaultTimeline.make([(100.0, 3, 1.0), (400.0, 5, 3.0)])
rep = replay(prof, 1001, tl, k=4, detector=DetectorConfig.default(500.0),
             controller=ControllerConfig(policy="debounce"))
assert rep.detection is not None
from repro_torch.sweeps import run_sweep, smoke_grid
assert run_sweep(smoke_grid(0)[:3], workers=0, measure_latency=False)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
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


_CHECKPOINT_PROBE = r"""
import sys
import repro_torch.checkpoint
import repro_torch.checkpoint._msgpack
import repro_torch.checkpoint.ckpt
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes"))
assert not bad, bad
print("IMPORTED")
"""


def test_checkpoint_needs_no_msgpack_nor_ml_dtypes():
    """The card's machine has neither package: the port's checkpoint
    module writes and reads the JAX format without them."""
    proc = subprocess.run([sys.executable, "-c", _CHECKPOINT_PROBE],
                          capture_output=True, text=True, env=_env(),
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def test_spawned_ranks_import_no_jax():
    """The processes of a gloo run (comms.dist.spawn) import every module
    of the port and load no JAX and nothing of the JAX package."""
    import pkgutil

    import repro_torch
    from repro_torch.comms import dist
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.launch.train" in names
    for loaded in dist.spawn(dist.imported_modules, 2, (names,)):
        assert "repro_torch" in loaded and "torch" in loaded
        assert not {"jax", "jaxlib", "repro"} & set(loaded), loaded


def test_resolve_device_never_falls_back():
    """cpu and cuda as asked; meta (the dry run's count) only when named,
    never as a default; any other device type raises."""
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        resolve_device("xpu")
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
