"""The port's fault-tolerant DP train step against the JAX one (4 forced
host devices, one subprocess): three healthy and three degraded steps from
the same JAX init on the same batches; then the launcher's failover log and
the data pipeline."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro.comms.fault import FaultState as JaxFaultState  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.comms import LocalTransport  # noqa: E402
from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.train import TrainState, make_dp_failover_step  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "train_step.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "train_step", str(out)], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _port_run(res, fault):
    model = build_model(get_config("qwen3-1.7b", smoke=True))
    opt = AdamWConfig(weight_decay=0.01)
    params = params_from_numpy(
        {k[len("init/"):]: v for k, v in res.items()
         if k.startswith("init/")}, "cpu")
    state = TrainState(params, init_state(params, opt), 0)
    step = make_dp_failover_step(model, LocalTransport(drv.P), opt,
                                 constant(drv.TRAIN_LR), fault)
    data = drv.train_data()
    losses, gnorms = [], []
    for i in range(drv.TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    assert state.step == drv.TRAIN_STEPS
    return np.asarray(losses), np.asarray(gnorms), \
        {k: v.detach().numpy() for k, v in state.params.items()}


@pytest.fixture(scope="module")
def port_runs(jax_run):
    return {"healthy": _port_run(jax_run, FaultState(drv.P)),
            "degraded": _port_run(jax_run, FaultState(drv.P, *drv.DEGRADED))}


@pytest.mark.parametrize("mode", ["healthy", "degraded"])
def test_dp_step_matches_jax(jax_run, port_runs, mode):
    losses, gnorms, params = port_runs[mode]
    np.testing.assert_allclose(losses, jax_run[f"{mode}/loss"], rtol=1e-5)
    np.testing.assert_allclose(gnorms, jax_run[f"{mode}/grad_norm"],
                               rtol=1e-5)
    # abs 1e-4 at lr 1e-3: AdamW divides by sqrt(nu) per element, so a
    # float-order difference in a near-zero gradient grows into an update
    # difference of up to lr
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_run[f"{mode}/params/{k}"],
                                   rtol=0, atol=1e-4, err_msg=k)


def test_degraded_step_equals_healthy_step(port_runs):
    """As tests/multidev_driver.py checks for JAX: OptCC training ==
    psum training up to fp tolerance."""
    h, d = port_runs["healthy"], port_runs["degraded"]
    np.testing.assert_allclose(d[0], h[0], rtol=0, atol=1e-5)
    for k in h[2]:
        np.testing.assert_allclose(d[2][k], h[2][k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_launcher_failover_log_matches_jax_planner(capsys):
    state, log = train_main(["--smoke", "--device", "cpu", "--dp", "4",
                             "--fail-at", "2", "--repair-at", "4",
                             "--steps", "6", "--seq-len", "32",
                             "--log-every", "1"])
    out = capsys.readouterr().out
    n_grad = sum(v.numel() for v in state.params.values())
    algo = JaxFaultState(4, 0, 1.5).plan(n_grad).algo
    lines = out.splitlines()
    degraded = [ln for ln in lines if "DEGRADED" in ln]
    assert degraded == [ln for ln in lines if ln.startswith("step 2:")]
    assert f"planner chose {algo}," in degraded[0]
    assert "step 4: REPAIRED; back to native psum" in lines
    assert lines[-1] == "done"
    assert [r["sync"] for r in log] == ["psum"] * 2 + ["optcc"] * 2 + \
        ["psum"] * 2
    assert all(np.isfinite(r["loss"]) for r in log)


def test_launcher_without_a_ring_disables_injection(capsys):
    train_main(["--smoke", "--device", "cpu", "--dp", "2", "--fail-at", "1",
                "--steps", "2", "--seq-len", "16"])
    assert "failure injection disabled" in capsys.readouterr().out
    with pytest.raises(NotImplementedError):
        train_main(["--smoke", "--device", "cpu", "--ckpt-dir", "x"])


@pytest.mark.parametrize("shard", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_batches_are_byte_equal(shard):
    cfg = dict(vocab_size=512, seq_len=33, global_batch=8, seed=5)
    ours = SyntheticLM(DataConfig(**cfg), *shard)
    ref = JaxSyntheticLM(JaxDataConfig(**cfg), *shard)
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
