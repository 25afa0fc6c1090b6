"""The launcher's checkpoint paths on the CPU: a run of 6 steps equals, bit
for bit, a run of 4 steps, a restart and 2 more; a restart inside the
degraded window behaves as the JAX launcher's does; and an elastic
rescale (--lose-node-at) from JAX's initial state matches the JAX
launcher's run (4 forced host devices, one subprocess)."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
RUN = ["--smoke", "--device", "cpu", "--dp", "4", "--seq-len", "32",
       "--fail-at", "2", "--repair-at", "4", "--log-every", "1"]
# the fields of a step record that do not depend on the clock
SAME = ("step", "loss", "grad_norm", "sync", "algo", "dp", "launches")


def _params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


def _records(log) -> list:
    return [{k: r[k] for k in SAME} for r in log]


@pytest.fixture(scope="module")
def uninterrupted():
    state, log = train_main(RUN + ["--steps", "6"])
    return _params(state), log


def test_resume_equals_an_uninterrupted_run(tmp_path, uninterrupted,
                                            capsys):
    params, log = uninterrupted
    ckpt = ["--ckpt-dir", str(tmp_path)]
    _, first = train_main(RUN + ckpt + ["--steps", "4", "--ckpt-every", "4"])
    assert [ev["op"] for ev in first[3]["checkpoint"]] == ["save"]
    assert first[3]["checkpoint"][0]["step"] == 4
    assert sorted(os.listdir(tmp_path)) == ["step_4"]
    capsys.readouterr()
    state, second = train_main(RUN + ckpt + ["--steps", "6"])
    assert "resumed from checkpoint at step 4 (" in capsys.readouterr().out
    assert state.step == 6
    restore = second[0]["checkpoint"]
    assert [ev["op"] for ev in restore] == ["restore"]
    assert restore[0]["bytes"] == \
        (tmp_path / "step_4" / "arrays.npz").stat().st_size
    assert _records(first) == _records(log[:4])
    assert _records(second) == _records(log[4:])
    for k, v in state.params.items():
        assert torch.equal(v, params[k]), k


def test_resume_inside_the_degraded_window_syncs_with_psum(tmp_path,
                                                          uninterrupted):
    """As in the JAX launcher, the injector's fault state is not in the
    checkpoint: a run resumed at step 3, inside the degraded window [2, 4),
    starts healthy and syncs with psum until the next event (the repair at
    4, a no-op then). psum and OptCC agree up to float order, so the run
    stays within the degraded-vs-healthy limit of the JAX multidev check."""
    params, log = uninterrupted
    ckpt = ["--ckpt-dir", str(tmp_path)]
    train_main(RUN + ckpt + ["--steps", "3", "--ckpt-every", "3"])
    state, resumed = train_main(RUN + ckpt + ["--steps", "6"])
    assert [r["sync"] for r in log] == ["psum"] * 2 + ["optcc"] * 2 + \
        ["psum"] * 2
    assert [r["sync"] for r in resumed] == ["psum"] * 3
    np.testing.assert_allclose([r["loss"] for r in resumed],
                               [r["loss"] for r in log[3:]], rtol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), params[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_elastic")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"), "elastic",
         str(out)], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out, dict(np.load(out / "elastic.npz"))


def _losses(lines) -> dict:
    return {int(m[1]): float(m[2]) for m in
            (re.match(r"step +(\d+) loss (\S+) ", ln) for ln in lines) if m}


def test_elastic_rescale_matches_the_jax_launcher(tmp_path, jax_elastic,
                                                  capsys):
    """Both launchers start from JAX's step_0 (the port through its own
    restore), lose half of 4 members at step 2, save, restore and go on
    with 2."""
    jax_dir, res = jax_elastic
    shutil.copytree(jax_dir / "ckpt" / "step_0", tmp_path / "step_0")
    state, log = train_main(["--device", "cpu", "--dp", str(drv.P),
                             "--ckpt-dir", str(tmp_path)] + drv.ELASTIC_ARGV)
    out = capsys.readouterr().out.splitlines()
    jax_lines = [str(x) for x in res["lines"]]
    assert jax_lines[0] == "resumed from checkpoint at step 0"
    assert out[0].startswith("resumed from checkpoint at step 0 (")
    node_loss = [ln for ln in out if "NODE LOSS" in ln]
    assert len(node_loss) == 1
    assert node_loss[0].startswith("step 2: NODE LOSS - resumed on 2 ")
    assert [ln.split(" - ")[0] for ln in jax_lines if "NODE LOSS" in ln] \
        == ["step 2: NODE LOSS"]
    assert [r["dp"] for r in log] == [4, 4, 2, 2]
    assert [ev["op"] for ev in log[2]["checkpoint"]] == \
        ["save", "restore", "rescale"]
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_2"]
    # JAX prints 4 decimals: within 1e-4 of its printed loss
    jax_losses = _losses(jax_lines)
    assert sorted(jax_losses) == [0, 1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in log],
                               [jax_losses[i] for i in range(4)], rtol=0,
                               atol=1e-4)
    # the multidev check's fp32 limit (the gap measured here: 2.4e-7)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), res[f"params/{k}"],
                                   rtol=0, atol=1e-5, err_msg=k)
