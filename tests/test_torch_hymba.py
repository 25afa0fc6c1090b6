"""hymba-1.5b (attention and Mamba heads in parallel, windowed attention
with rolling caches) in the port against the JAX package, on its smoke
config (2 layers, d 60, 5/5 heads of head dim 12, window 16, ssm_state 4,
fp32). Parameters come from the JAX `init` through `convert.py`. Loss and
every gradient leaf; prefill logits and every cache leaf; every greedy
decode step's logits and the final caches, also after a prompt longer
than the window (the ring wraps in the prefill) and than a shortened
`ssm_chunk` with a ragged last chunk; decode against JAX's and the port's
own `forward`; the tokens of `generate`; three DP steps healthy and
degraded against the JAX step (tests/jax_reference.py train_step --arch
hymba-1.5b, in a subprocess with 4 forced host devices). Also: the chunked
scan's padded steps leave the SSM state as it was; the bf16 parameter tree
with its fp32 leaves converts one to one, trains through the launcher and
keeps its dtypes through a checkpoint; the per-dtype healthy sync equals
the single fp32 buffer's, bit for bit."""
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
from repro.models import hymba as jax_hymba  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402

from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.comms import LocalTransport, psum_tree  # noqa: E402
from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model, hymba  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.train.serve import generate, pad_cache_to  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402
from test_torch_train_step import port_run  # noqa: E402

ARCH = "hymba-1.5b"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
SERVE_TOL = 2e-4                  # tests/test_serve_equivalence.py
REPO = pathlib.Path(__file__).resolve().parent.parent
# (prompt, total, ssm_chunk): a prompt inside the 16-slot window and
# shorter than the chunk; one of 21 tokens that wraps the rings in the
# prefill and, at ssm_chunk 8, ends in a ragged chunk of 5 steps
SERVE_CASES = [(12, 20, None), (21, 30, 8)]
SERVE_IDS = ["in-window", "wrapped-ragged"]


def _both(seed, **overrides):
    """The JAX smoke model and its init; the port's model and the same
    parameters converted (both configs with `overrides`)."""
    jmodel = jax_build_model(jax_get_config(ARCH, smoke=True)
                             .replace(**overrides))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = build_model(get_config(ARCH, smoke=True).replace(**overrides))
    return jmodel, jparams, model, params_from_numpy(flat_numpy(jparams),
                                                     "cpu")


def _close(got, want, what, scaled=False):
    """Within SERVE_TOL (1 + |want|); `scaled`: the absolute part scaled
    by the leaf's largest magnitude, for the SSM state, whose elements
    (up to ~2e3 at the smoke config's init) are sums of terms as large as
    its largest, so an fp32 rounding of those terms (1.2e-4 at 2e3) can
    land on an element near 0."""
    want = np.asarray(want, np.float32)
    atol = SERVE_TOL * (max(1.0, float(np.abs(want).max())) if scaled
                        else 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=SERVE_TOL, atol=atol, err_msg=what)


def test_loss_and_grads_match_jax():
    cfg = get_config(ARCH, smoke=True)
    jmodel, jparams, model, params = _both(0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 25))
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
        gap = np.linalg.norm(g.numpy() - want)
        assert gap <= 2 * GRAD_TOL * np.linalg.norm(want), (key, gap)


@pytest.mark.parametrize("prompt,total,ssm_chunk", SERVE_CASES,
                         ids=SERVE_IDS)
def test_prefill_and_decode_match_jax(prompt, total, ssm_chunk):
    """Prefill, then decode token by token to `total`: the prefill's
    logits and every cache leaf (rings, conv and SSM states), each step's
    logits, and the caches at the end equal JAX's; each step's logits also
    equal the teacher-forced forward's, JAX's and the port's."""
    overrides = {"ssm_chunk": ssm_chunk} if ssm_chunk else {}
    jmodel, jparams, model, params = _both(5, **overrides)
    cfg = model.cfg
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, total)).astype(np.int32)
    jfull = jnp.einsum("bsd,dv->bsv", jax.jit(
        lambda p, t: jax_hymba.forward(jmodel.cfg, p, t))(
            jparams, jnp.asarray(toks)), jparams["lm_head"])
    with torch.no_grad():
        full = hymba.forward(cfg, params, torch.from_numpy(toks).long()) \
            @ params["lm_head"]
    _close(full, jfull, "forward")
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :prompt])})
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, :prompt]).long()})
    _close(logits, jlogits, "prefill logits")
    assert sorted(cache) == sorted(jcache) == ["conv", "k", "ssm", "v"]
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close(cache[key], jcache[key], f"prefill cache {key}",
               scaled=key == "ssm")
    assert pad_cache_to(cache, total)["k"] is cache["k"]   # rings stay
    jstep = jax.jit(jmodel.decode_step)
    for pos in range(prompt, total):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        with torch.no_grad():
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(tok).long(), pos)
        _close(lg, jlg, f"decode logits at {pos}")
        _close(lg, jfull[:, pos], f"decode vs JAX forward at {pos}")
        _close(lg, full[:, pos], f"decode vs forward at {pos}")
    for key in cache:
        _close(cache[key], jcache[key], f"cache {key} at the end",
               scaled=key == "ssm")


def test_padded_scan_steps_leave_the_state():
    """A ragged last chunk is zero-padded, as JAX pads it: the scan's
    inputs of a padded step are 0, delta among them, so dA = exp(0) = 1,
    dBx = 0 and the state passes unchanged (unlike rwkv6's, ROADMAP §3).
    The final SSM and conv states at ssm_chunk 8 over 21 steps equal those
    of one 21-step chunk to the bit; the outputs agree up to the float
    order of the C contraction over other chunk shapes."""
    cfg = get_config(ARCH, smoke=True)
    params = build_model(cfg).init(2, "cpu")
    bp = {k[len("blocks/"):]: v[0] for k, v in params.items()
          if k.startswith("blocks/")}
    h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        one = hymba._mamba_scan(cfg, bp, h)
        ragged = hymba._mamba_scan(cfg.replace(ssm_chunk=8), bp, h)
    assert torch.equal(ragged[2], one[2]) and torch.equal(ragged[1], one[1])
    torch.testing.assert_close(ragged[0], one[0], rtol=1e-6, atol=1e-6)


def test_generate_tokens_equal_jax():
    jmodel, jparams, model, params = _both(6)
    prompt = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 20)).astype(np.int32)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), 8)
    got = generate(model, params, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bf16(cfg):
    """The smoke config (JAX's or the port's) with bf16 params and
    compute, the dtypes of the full config."""
    return cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")


def test_bf16_params_convert_one_to_one_with_fp32_leaves():
    """hymba's bf16 tree keeps m_dt_bias, m_alog and m_d in fp32: every
    leaf of the JAX init converts bit-exactly both ways, and the port's
    own init has the same paths, order, shapes and dtypes."""
    jcfg = _bf16(jax_get_config(ARCH, smoke=True))
    tree = flat_numpy(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(4)))
    params = params_from_numpy(tree, "cpu")
    for key in ("m_dt_bias", "m_alog", "m_d"):
        assert params["blocks/" + key].dtype == torch.float32
    assert params["blocks/m_in"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    ours = build_model(_bf16(get_config(ARCH, smoke=True))).init(0, "cpu")
    assert list(ours) == list(tree)
    for k, v in ours.items():
        assert tuple(v.shape) == tree[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(tree[k].dtype), k
    # the fp32 leaves are those of the JAX formulas, to the bit
    np.testing.assert_array_equal(ours["blocks/m_d"].numpy(),
                                  tree["blocks/m_d"])
    np.testing.assert_allclose(ours["blocks/m_alog"].numpy(),
                               tree["blocks/m_alog"], rtol=1e-7)


def _mixed_members(p=4, seed=9):
    """p members' gradients of the bf16 tree: bf16 leaves and fp32 ones."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in build_model(
        _bf16(get_config(ARCH, smoke=True))).init(0, "cpu").items()}
    gen = torch.Generator().manual_seed(seed)
    return [[torch.randn(s, generator=gen).to(dt) for s, dt in
             shapes.values()] for _ in range(p)]


def test_per_dtype_psum_tree_equals_one_fp32_buffer():
    """The healthy sync packs one buffer per leaf dtype (one W-way launch
    each): bit for bit the single fp32 buffer's sum cast back per leaf,
    since both add the exact inputs in fp32 in member order and round
    once."""
    members = _mixed_members()
    got = psum_tree(iter(members), LocalTransport(4))
    for i, leaves in enumerate(zip(*members)):
        acc = leaves[0].float()
        for leaf in leaves[1:]:
            acc = acc + leaf.float()
        want = acc.to(leaves[0].dtype)
        assert got[i].dtype == want.dtype and got[i].shape == want.shape
        assert torch.equal(got[i], want), i


def test_bf16_train_state_keeps_its_dtypes_through_a_checkpoint(tmp_path):
    cfg = _bf16(get_config(ARCH, smoke=True))
    params = build_model(cfg).init(3, "cpu")
    opt = AdamWConfig()
    state = TrainState(params, init_state(params, opt), 5)
    save(tmp_path, 5, state)
    blank = {k: torch.zeros_like(v) for k, v in params.items()}
    got, meta = restore(tmp_path, TrainState(blank, init_state(blank, opt),
                                             0))
    assert int(meta["step"]) == 5
    for k, v in params.items():
        assert got.params[k].dtype == v.dtype, k
        assert torch.equal(got.params[k], v), k
    assert got.params["blocks/m_alog"].dtype == torch.float32


def test_launcher_failover_on_hymba_smoke(capsys):
    state, log = train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--dp", "4", "--fail-at", "1", "--repair-at",
                             "3", "--steps", "4", "--seq-len", "32",
                             "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [r["sync"] for r in log] == ["psum", "optcc", "optcc", "psum"]
    assert any("DEGRADED" in ln for ln in out)
    assert all(np.isfinite(r["loss"]) for r in log)
    assert state.params["blocks/m_alog"].dtype == torch.float32


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
    """Three steps from the same JAX init on the same batches. The losses
    and the first step's grad norm (from equal parameters) at the qwen3 DP
    test's 1e-5 (tests/test_torch_train_step.py). The later grad norms are
    poorly conditioned, as internlm2's are (tests/test_torch_dense_configs.py):
    against a float64 run of the port, JAX's fp32 norm at step 1 is off by
    1.6e-4 and the port's by 3.0e-4 (tools/fp32_conditioning.py --dp), so
    two fp32 runs are held to 1e-3.
    Parameters to the internlm2 DP test's AdamW sign-flip bound: each at
    most 2 lr a step apart, at most 1e-3 of a leaf past 1e-4."""
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
