"""gemma3's local:global attention in the port's training path against the
JAX package, on the smoke config (6 layers, 5 local and 1 global, window
16, fp32): the launcher's healthy -> degraded -> repaired run on the CPU,
and three DP steps, healthy and degraded, from the same JAX init on the
same batches (the JAX side in a subprocess with 4 forced host devices,
tests/jax_reference.py train_step --arch gemma3-27b)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from test_torch_train_step import port_run  # noqa: E402

ARCH = "gemma3-27b"
REPO = pathlib.Path(__file__).resolve().parent.parent


def test_launcher_failover_on_gemma3_smoke(capsys):
    state, log = train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--dp", "4", "--fail-at", "2", "--repair-at",
                             "4", "--steps", "6", "--seq-len", "32",
                             "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [r["sync"] for r in log] == ["psum"] * 2 + ["optcc"] * 2 + \
        ["psum"] * 2
    assert any("DEGRADED" in ln for ln in out)
    assert "step 4: REPAIRED; back to native psum" in out
    assert all(np.isfinite(r["loss"]) for r in log)
    assert state.params["blocks/wq"].shape[0] == 6


@pytest.fixture(scope="module")
def jax_dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "train_step.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "train_step", str(out), "--arch", ARCH], capture_output=True,
        text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("mode", ["healthy", "degraded"])
def test_dp_step_matches_jax(jax_dp_run, mode):
    """Three steps from the same JAX init, at the qwen3 DP test's limits
    (tests/test_torch_train_step.py)."""
    fault = FaultState(drv.P) if mode == "healthy" else \
        FaultState(drv.P, *drv.DEGRADED)
    losses, gnorms, params = port_run(jax_dp_run, fault, ARCH)
    np.testing.assert_allclose(losses, jax_dp_run[f"{mode}/loss"], rtol=1e-5)
    np.testing.assert_allclose(gnorms, jax_dp_run[f"{mode}/grad_norm"],
                               rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_dp_run[f"{mode}/params/{k}"],
                                   rtol=0, atol=1e-4, err_msg=k)
