"""rwkv6 training in the port against the JAX package, on its smoke config
(2 layers, d 64, 8 heads of head dim 8, fp32). JAX trains rwkv6 through
the differentiable `chunked_scan` of its per-token step (its config leaves
`use_wkv_kernel` False; the Pallas wkv kernel has no VJP), and so does the
port (`rwkv6._wkv_scan` under autograd). Parameters come from the JAX
`init` through `convert.py`.

The loss and every gradient leaf against `jax.grad` of JAX's `loss_fn`,
within one chunk and over several, a ragged last chunk among them (its
zero final state, ROADMAP §3, does not reach the loss); the scan's
outputs against the serving path's wkv op; three DP steps healthy and
degraded against the JAX step (tests/jax_reference.py train_step --arch
rwkv6-7b, in a subprocess with 4 forced host devices); the training
launcher through healthy -> degraded -> repaired, and its trained
parameters served."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402

from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.wkv import wkv  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model, rwkv6  # noqa: E402
from repro_torch.train.serve import generate  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402
from test_torch_train_step import port_run  # noqa: E402

ARCH = "rwkv6-7b"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
REPO = pathlib.Path(__file__).resolve().parent.parent
# (S, ssm_chunk): one chunk (the config's 256); three chunks of 8; a
# ragged last chunk (21 = 2 x 8 + 5)
LOSS_CASES = [(24, None), (24, 8), (21, 8)]
LOSS_IDS = ["one-chunk", "chunks", "ragged"]


@pytest.mark.parametrize("S,ssm_chunk", LOSS_CASES, ids=LOSS_IDS)
def test_loss_and_grads_match_jax(S, ssm_chunk):
    overrides = {"ssm_chunk": ssm_chunk} if ssm_chunk else {}
    jcfg = jax_get_config(ARCH, smoke=True).replace(**overrides)
    assert not jcfg.use_wkv_kernel          # JAX trains through its scan
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(get_config(ARCH, smoke=True).replace(**overrides))
    params = params_from_numpy(flat_numpy(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               (2, S + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -100                    # masked positions
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    jgrads = flat_numpy(jgrads)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert sorted(jgrads) == sorted(params)
    # norm-wise per leaf, the sum of two fp32 runs' errors of up to 1e-4 of
    # a leaf's norm (tests/test_torch_dense_configs.py)
    for key, g in zip(params, grads):
        want = jgrads[key]
        assert np.linalg.norm(want) > 0, key
        gap = np.linalg.norm(g.numpy() - want)
        assert gap <= 2 * GRAD_TOL * np.linalg.norm(want), (key, gap)


@pytest.mark.parametrize("S,ssm_chunk", [(24, 256), (24, 8), (21, 8)],
                         ids=LOSS_IDS)
def test_scan_matches_the_wkv_op(S, ssm_chunk):
    """The training scan's outputs equal the serving path's wkv op (its
    plain version here) at the JAX kernel tests' fp32 limit; so does its
    final state, except after a ragged chunk, whose padded steps (w = 0)
    leave it zero, as JAX's scan does."""
    cfg = get_config(ARCH, smoke=True).replace(ssm_chunk=ssm_chunk)
    H, hd = cfg.d_model // cfg.ssm_state, cfg.ssm_state
    rng = np.random.default_rng(2)
    r, k, v = (torch.from_numpy(rng.standard_normal((2, S, H, hd))
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, H, hd))
                         .astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((H, hd)).astype(np.float32))
    out, state = rwkv6._wkv_scan(cfg, r, k, v, w, u)
    want, want_state = wkv(r, k, v, w, u)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    if S % ssm_chunk and S > ssm_chunk:
        assert not state.any()
    else:
        torch.testing.assert_close(state, want_state, rtol=1e-5, atol=1e-5)


def test_launcher_trains_rwkv6_smoke(capsys):
    state, log = train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--dp", "4", "--fail-at", "1", "--repair-at",
                             "3", "--steps", "4", "--seq-len", "32",
                             "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [r["sync"] for r in log] == ["psum", "optcc", "optcc", "psum"]
    assert any("DEGRADED" in ln for ln in out)
    assert all(np.isfinite(r["loss"]) for r in log)
    assert state.params["blocks/w_base"].dtype == torch.float32
    # the trained parameters (the step marks them requires_grad) serve
    # through the wkv op under generate's no_grad
    assert state.params["blocks/bonus"].requires_grad
    model = build_model(get_config(ARCH, smoke=True))
    tokens = generate(model, state.params, torch.arange(8).reshape(2, 4), 3)
    assert tokens.shape == (2, 3)


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
    """Three steps from the same JAX init on the same batches: losses and
    the first grad norm at the qwen3 DP test's 1e-5
    (tests/test_torch_train_step.py), the later grad norms at 1e-3 and the
    parameters at the AdamW sign-flip bound of the hymba and internlm2 DP
    tests (tests/test_torch_hymba.py): each at most 2 lr a step apart, at
    most 1e-3 of a leaf past 1e-4."""
    fault = FaultState(drv.P) if mode == "healthy" else \
        FaultState(drv.P, *drv.DEGRADED)
    losses, gnorms, params = port_run(jax_dp_run, fault, ARCH)
    np.testing.assert_allclose(losses, jax_dp_run[f"{mode}/loss"], rtol=1e-5)
    gref = jax_dp_run[f"{mode}/grad_norm"]
    np.testing.assert_allclose(gnorms[0], gref[0], rtol=1e-5)
    np.testing.assert_allclose(gnorms[1:], gref[1:], rtol=1e-3)
    bound = 2 * drv.TRAIN_LR * drv.TRAIN_STEPS
    for k, v in params.items():
        gap = np.abs(v - jax_dp_run[f"{mode}/params/{k}"])
        assert gap.max() <= bound, (k, gap.max())
        assert (gap > 1e-4).sum() <= 1e-3 * gap.size, (k, (gap > 1e-4).sum())
