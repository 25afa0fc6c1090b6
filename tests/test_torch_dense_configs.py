"""The dense decoders of this slice against the JAX package, on their smoke
configs in fp32: internlm2-1.8b (untied lm_head), minicpm-2b (MHA, head
dim 12) and qwen2-vl-2b (M-RoPE, a patch-embedding prefix, head dim 12).
Parameters come from the JAX `init` through `convert.py`. Loss and every
gradient leaf, also with a prefix batch and unequal (t, h, w) ids; prefill
logits, every greedy decode step's logits and the tokens of `generate`;
three DP steps of internlm2 against the JAX step (tests/jax_reference.py
train_step --arch internlm2-1.8b, in a subprocess with 4 forced host
devices); `apply_mrope` and the `cosine` schedule against JAX's."""
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
from repro.models.common import apply_mrope as jax_apply_mrope  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro.train.serve import pad_cache_to as jax_pad_cache_to  # noqa: E402

from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import (apply_mrope, apply_rope,  # noqa: E402
                                       mrope_sections)
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.train.serve import generate, pad_cache_to  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402
from test_torch_train_step import port_run  # noqa: E402

ARCHS = ["internlm2-1.8b", "minicpm-2b", "qwen2-vl-2b"]
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
SERVE_TOL = 2e-4                  # tests/test_serve_equivalence.py
REPO = pathlib.Path(__file__).resolve().parent.parent


def _both(arch, seed):
    """The JAX smoke model and its init; the port's model and the same
    parameters converted."""
    jmodel = jax_build_model(jax_get_config(arch, smoke=True))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = build_model(get_config(arch, smoke=True))
    return jmodel, jparams, model, params_from_numpy(flat_numpy(jparams),
                                                     "cpu")


def _loss_and_grads(arch, batch, seed=0):
    """JAX's and the port's loss and gradients on one numpy batch."""
    jmodel, jparams, model, params = _both(arch, seed)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    for t in params.values():
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch.update({k: tbatch[k].long() for k in ("tokens", "labels",
                                                 "positions") if k in batch})
    loss = model.loss(params, tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    jgrads = flat_numpy(jgrads)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert sorted(jgrads) == sorted(params)
    # norm-wise per leaf: at init these losses sit near log(vocab), so the
    # gradients are small differences and fp32 carries a relative error of
    # up to 1e-4 in each (JAX's own fp32 gradients are up to 9.9e-5
    # norm-wise from a float64 run of the port here, and the embedding's,
    # which passes through the first RMS norm at ~50x, up to 3e-4
    # elementwise); two fp32 runs may differ by the sum of their errors
    for key, g in zip(params, grads):
        want = jgrads[key]
        gap = np.linalg.norm(g.numpy() - want)
        assert gap <= 2 * GRAD_TOL * np.linalg.norm(want), (key, gap)
    return params


def _text_batch(cfg, seed, B=2, S=24):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (B, S + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -100                    # masked positions
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg = get_config(arch, smoke=True)
    params = _loss_and_grads(arch, _text_batch(cfg, 1))
    # internlm2's head is its own leaf, trained through the loss
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert (arch == "internlm2-1.8b") == ("lm_head" in params)


def _prefix_batch(cfg, seed, B=2, S=24):
    """tests/test_arch_smoke.py's vlm batch: tokens as labels and a
    standard-normal (B, n_patch_tokens, d) prefix."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy(),
            "prefix_embeds": rng.standard_normal(
                (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("ids", ["text", "unequal"])
def test_qwen2_vl_prefix_batch_matches_jax(ids):
    """A patch prefix of 8 embeddings before 24 tokens, its labels masked;
    with the default text positions, and with random (t, h, w) ids for
    the 32 positions (as an image's patches carry)."""
    cfg = get_config("qwen2-vl-2b", smoke=True)
    batch = _prefix_batch(cfg, 2)
    if ids == "unequal":
        B, S = batch["tokens"].shape
        batch["positions"] = np.random.default_rng(3).integers(
            0, 64, (B, cfg.n_patch_tokens + S, 3)).astype(np.int32)
    _loss_and_grads("qwen2-vl-2b", batch, seed=4)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=SERVE_TOL,
                               atol=SERVE_TOL, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 12 tokens, then decode to 20 token by token: the logits of
    the prefill and of every step, and the caches, equal JAX's."""
    B, prompt, total = 2, 12, 20
    jmodel, jparams, model, params = _both(arch, 5)
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (B, total)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :prompt])})
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :prompt]).long()})
    _close(logits, jlogits, "prefill logits")
    jcache, cache = jax_pad_cache_to(jcache, total), pad_cache_to(cache, total)
    jstep = jax.jit(jmodel.decode_step)
    for pos in range(prompt, total):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(tok).long(), pos)
        _close(lg, jlg, f"decode logits at {pos}")
    for key in cache:
        _close(cache[key], jcache[key], f"cache {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_jax(arch):
    jmodel, jparams, model, params = _both(arch, 6)
    prompt = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), 8)
    got = generate(model, params, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "train_step.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "train_step", str(out), "--arch", "internlm2-1.8b"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("mode", ["healthy", "degraded"])
def test_internlm2_dp_step_matches_jax(jax_dp_run, mode):
    """Three DP steps of the untied head through the sync, healthy (psum)
    and degraded (OptCC), from the same JAX init on the same batches, at
    the qwen3 DP test's limits (tests/test_torch_train_step.py)."""
    fault = FaultState(drv.P) if mode == "healthy" else \
        FaultState(drv.P, *drv.DEGRADED)
    losses, gnorms, params = port_run(jax_dp_run, fault, "internlm2-1.8b")
    np.testing.assert_allclose(losses, jax_dp_run[f"{mode}/loss"], rtol=1e-5)
    # the grad norm is mostly the embedding's gradient, whose fp32 error
    # is up to 1e-4 of its norm (test_loss_and_grads_match_jax): the first
    # step's, from equal parameters, within the sum of two such errors;
    # the later ones are of parameters that parted as below
    gref = jax_dp_run[f"{mode}/grad_norm"]
    np.testing.assert_allclose(gnorms[0], gref[0], rtol=2 * GRAD_TOL)
    np.testing.assert_allclose(gnorms[1:], gref[1:], rtol=5 * GRAD_TOL)
    # the untied head, synced with the rest, within the qwen3 DP test's
    # 1e-4 (tests/test_torch_train_step.py)
    np.testing.assert_allclose(params["lm_head"],
                               jax_dp_run[f"{mode}/params/lm_head"], rtol=0,
                               atol=1e-4)
    # elsewhere AdamW's per-element normalisation turns an fp32 error in a
    # gradient element near 0 into an update of the other sign: such an
    # element parts by at most 2 lr a step, and few of them do
    bound = 2 * drv.TRAIN_LR * drv.TRAIN_STEPS
    for k, v in params.items():
        gap = np.abs(v - jax_dp_run[f"{mode}/params/{k}"])
        assert gap.max() <= bound, (k, gap.max())
        assert (gap > 1e-4).sum() <= 1e-3 * gap.size, (k, (gap > 1e-4).sum())


@pytest.mark.parametrize("hd,sections", [(12, (1, 2, 3)), (16, (2, 3, 3)),
                                         (128, (16, 24, 24))])
@pytest.mark.parametrize("ids", ["random", "equal"])
def test_apply_mrope_matches_jax(hd, sections, ids):
    """Within one fp32 rounding of the rotated values (the two libraries'
    cos and sin differ in the last bit); with equal ids it is the port's
    own RoPE, to the bit."""
    assert tuple(mrope_sections(hd)) == sections
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    if ids == "random":
        pos = rng.integers(0, 2048, (2, 7, 3))
    else:
        pos = np.repeat(rng.integers(0, 2048, (2, 7, 1)), 3, axis=-1)
    want = np.asarray(jax_apply_mrope(jnp.asarray(x),
                                      jnp.asarray(pos.astype(np.int32)),
                                      1e6))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if ids == "equal":
        rope = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]),
                          1e6)
        assert torch.equal(got, rope)


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_cosine_matches_jax(warmup):
    total = 50
    ours, ref = schedules.cosine(3e-4, warmup, total), \
        jsched.cosine(3e-4, warmup, total)
    for step in range(total + 6):
        got, want = ours(step), ref(step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=0.0)
    assert float(ours(total + 5)) == pytest.approx(3e-5, rel=1e-6)
