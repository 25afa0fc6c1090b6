"""The MoE family (phi3.5-moe: 16 experts top-2; arctic-480b: 128 experts
top-2 plus a dense residual FFN) in the port against the JAX package, on
their smoke configs (2 layers, d 64, 8/2 heads of head dim 8, 4 and 8
experts, fp32). Parameters come from the JAX `init` through `convert.py`.

`moe_ffn` on the same numpy inputs: the routing (top-k ids, kept slots,
slot positions) equal to JAX's exactly, then the outputs, in fp32 and
bf16, at the default capacity, at capacity factor 0.5 (tokens dropped)
and at S = 1 (the decode shape); arctic's dense residual; the auxiliary
load-balance loss; the init's parameter tree. Then the whole model: loss
and every gradient leaf, prefill and decode logits and caches against
JAX's prefill and decode at the default capacity, decode against the
port's own forward at capacity factor 8 (no drops, as
tests/test_serve_equivalence.py), the tokens of `generate`, three DP steps
healthy and degraded against the JAX step (tests/jax_reference.py
train_step --arch ARCH, in a subprocess with 4 forced host devices; the
first step tightly, the later ones to what their fp32 conditioning
allows), and the training launcher through healthy -> degraded ->
repaired."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro.train.serve import pad_cache_to as jax_pad_cache_to  # noqa: E402

from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model, moe, transformer  # noqa: E402
from repro_torch.models.common import init_dense, swiglu  # noqa: E402
from repro_torch.train.serve import generate, pad_cache_to  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402
from test_torch_model import _LiveFp32  # noqa: E402
from test_torch_train_step import port_run  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]
ARCH_IDS_SHORT = ["phi35", "arctic"]
# moe_ffn: max |port - JAX| within TOL of the output's largest magnitude
# (the smoke experts' outputs reach ~2e3: an element near 0 is a sum of
# terms that large); fp32 and bf16 as the JAX kernel tests
# (tests/test_kernels.py)
FFN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
SERVE_TOL = 2e-4                  # tests/test_serve_equivalence.py
REPO = pathlib.Path(__file__).resolve().parent.parent
# (capacity factor, S): the default; 0.5, where half the slots drop; the
# decode step's one token
FFN_CASES = [(1.25, 24), (0.5, 24), (1.25, 1)]
FFN_IDS = ["default", "drops", "decode"]


def _configs(arch, **overrides):
    return (jax_get_config(arch, smoke=True).replace(**overrides),
            get_config(arch, smoke=True).replace(**overrides))


def _jax_routing(cfg, x, router):
    """JAX moe_ffn's routing, line for line (src/repro/models/moe.py):
    (topi, keep, pos_c)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router)
    gates = jax.nn.softmax(logits, axis=-1)
    _, topi = lax.top_k(gates, k)
    cap = max(int(round(cfg.capacity_factor * k * S / E)), 1)
    flat_e = topi.reshape(B, S * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(
        lambda se: jnp.searchsorted(se, se, side="left"))(sorted_e)
    pos_in_e = jnp.arange(S * k)[None] - first
    keep = pos_in_e < cap
    return topi, keep, jnp.where(keep, pos_in_e, cap)


def _layer_inputs(arch, dtype, S, seed=0, **overrides):
    """Layer 0 of a JAX init of the smoke config's MoE leaves (2 layers,
    so scaled as in the model), both ways, and standard-normal x (2, S, d)
    (the FFN's input is RMS-normed) in `dtype`; the router stays fp32."""
    jcfg, cfg = _configs(arch, param_dtype=dtype, **overrides)
    jbp = {k: v[0] for k, v in jax_moe.init_moe_params(
        jcfg, jax.random.PRNGKey(seed), jcfg.n_layers).items()}
    bp = params_from_numpy(flat_numpy(jbp), "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, cfg, jbp, bp, jx, tx


def _held(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("cf,S", FFN_CASES, ids=FFN_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_moe_ffn_matches_jax(arch, dtype, cf, S):
    jcfg, cfg, jbp, bp, jx, tx = _layer_inputs(arch, dtype, S,
                                               capacity_factor=cf)
    r = moe.route(cfg, tx, bp["router"])
    topi, keep, pos_c = _jax_routing(jcfg, jx, jbp["router"])
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r.pos_c.numpy(), np.asarray(pos_c))
    if cf < 1:
        assert (~r.keep).sum() > 0          # the drop path runs
    y = moe.moe_ffn(cfg, tx, bp)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _held(y, jax_moe.moe_ffn(jcfg, jx, jbp), FFN_TOL[dtype], arch)


def test_capacity_rounds_half_to_even_as_jax():
    cfg = get_config("phi3.5-moe-42b-a6.6b")     # 16 experts top-2
    # 1.25 * 2 * S / 16: 0.15625 at S 1 (at least 1), 2.5 at S 16 (to 2),
    # 3.75 at S 24, 320 at S 2048
    assert [moe.capacity(cfg, s) for s in (1, 16, 24, 2048)] == \
        [1, 2, 4, 320]
    assert moe.capacity(get_config("arctic-480b"), 2048) == 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_dense_residual_matches_jax(dtype):
    """arctic adds swiglu(x, d_gate, d_up, d_down) after the experts: the
    port's and JAX's residuals (each the full FFN less its experts-only
    FFN) agree, and the port's equals `swiglu` on those leaves."""
    jcfg, cfg, jbp, bp, jx, tx = _layer_inputs("arctic-480b", dtype, 24,
                                               seed=3)
    experts = {k: v for k, v in bp.items() if not k.startswith("d_")}
    jexperts = {k: v for k, v in jbp.items() if not k.startswith("d_")}
    got = (moe.moe_ffn(cfg, tx, bp).float()
           - moe.moe_ffn(cfg.replace(moe_dense_ff=0), tx, experts).float())
    want = (np.asarray(jax_moe.moe_ffn(jcfg, jx, jbp), np.float32)
            - np.asarray(jax_moe.moe_ffn(jcfg.replace(moe_dense_ff=0), jx,
                                         jexperts), np.float32))
    dense = swiglu(tx, bp["d_gate"], bp["d_up"], bp["d_down"]).float()
    scale = float(np.abs(np.asarray(jax_moe.moe_ffn(jcfg, jx, jbp),
                                    np.float32)).max())
    tol = FFN_TOL[dtype] * scale
    assert float(dense.abs().max()) > 10 * tol     # the residual matters
    assert float((got - torch.from_numpy(want)).abs().max()) <= tol
    assert float((got - dense).abs().max()) <= tol


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_aux_load_balance_loss_matches_jax(arch):
    jcfg, cfg, jbp, bp, jx, tx = _layer_inputs(arch, "float32", 24, seed=4)
    want = float(jax_moe.aux_load_balance_loss(jcfg, jx, jbp["router"]))
    got = float(moe.aux_load_balance_loss(cfg, tx, bp["router"]))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_param_tree_matches_jax_init(arch, dtype):
    """The MoE leaves of `init_moe_params` and the whole model's tree:
    the same paths, order, shapes and dtypes as the JAX init (the router
    fp32 whatever the parameter dtype; no dense w_gate / w_up / w_down);
    the counts equal."""
    jcfg, cfg = _configs(arch, param_dtype=dtype)
    jleaves = flat_numpy(jax_moe.init_moe_params(
        jcfg, jax.random.PRNGKey(0), 3))
    leaves = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), 3)
    assert sorted(leaves) == sorted(jleaves)
    for k, v in leaves.items():
        assert tuple(v.shape) == jleaves[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(jleaves[k].dtype)
    jtree = flat_numpy(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    model = build_model(cfg)
    ours = model.init(0, "cpu")
    assert list(ours) == list(jtree)
    assert "blocks/w_gate" not in ours
    assert ours["blocks/router"].dtype == torch.float32
    for k, v in ours.items():
        assert tuple(v.shape) == jtree[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(jtree[k].dtype), k
    assert model.param_count(ours) == sum(a.size for a in jtree.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_dense_draws_a_4d_leaf_one_expert_slice_at_a_time(dtype):
    """A stacked (L, E, a, b) expert leaf is drawn one (a, b) slice at a
    time: at arctic-480b's width one slice is 0.14 GB of fp32, where a
    layer's (E, a, b) would be 17.9 GB. The values are scaled by
    1/sqrt(L), as the JAX init scales them, and equal the same generator's
    draws of the slices in turn."""
    L, E, a, b = 3, 4, 32, 48
    gen = torch.Generator().manual_seed(0)
    with _LiveFp32() as mode:
        got = init_dense((L, E, a, b), gen, dtype=dtype)
    result = got.numel() * 4 if dtype == torch.float32 else 0
    assert mode.peak == result + a * b * 4
    gen = torch.Generator().manual_seed(0)
    want = torch.stack([torch.randn((a, b), generator=gen)
                        for _ in range(L * E)]).reshape(L, E, a, b)
    assert torch.equal(got, (want * (1.0 / np.sqrt(L))).to(dtype))


def _both(arch, seed, **overrides):
    jcfg, cfg = _configs(arch, **overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jmodel, jparams, build_model(cfg), params_from_numpy(
        flat_numpy(jparams), "cpu")


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, model, params = _both(arch, 0)
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                               (2, 25))
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


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=SERVE_TOL,
                               atol=SERVE_TOL, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_prefill_and_decode_match_jax(arch):
    """At the default capacity, where the prefill's 12 tokens may drop
    slots: prefill, then decode to 20 token by token; the logits of the
    prefill and of every step, and the caches, equal JAX's own prefill's
    and decode's."""
    B, prompt, total = 2, 12, 20
    jmodel, jparams, model, params = _both(arch, 5)
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (B, total)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :prompt])})
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, :prompt]).long()})
    _close(logits, jlogits, "prefill logits")
    jcache, cache = jax_pad_cache_to(jcache, total), pad_cache_to(cache, total)
    jstep = jax.jit(jmodel.decode_step)
    for pos in range(prompt, total):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        with torch.no_grad():
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(tok).long(), pos)
        _close(lg, jlg, f"decode logits at {pos}")
    for key in cache:
        _close(cache[key], jcache[key], f"cache {key}")


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_decode_matches_forward_without_drops(arch):
    """tests/test_serve_equivalence.py::test_decode_matches_forward for the
    port: capacity drops depend on the sequence length the router sees, so
    prefill(S/2) and forward(S) legitimately differ under drops; at
    capacity factor 8 nothing drops, and the prefill's and every decode
    step's logits equal the teacher-forced forward's (the port's, and
    JAX's)."""
    jcfg, cfg = _configs(arch, capacity_factor=8.0)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1))
    model = build_model(cfg)
    params = params_from_numpy(flat_numpy(jparams), "cpu")
    B, S, prompt = 2, 24, 12
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    jfull = jnp.einsum(
        "bsd,dv->bsv", jax_transformer.forward(jcfg, jparams,
                                               jnp.asarray(toks)),
        jax_transformer.unembed_matrix(jcfg, jparams))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        full = transformer.forward(cfg, params, t) \
            @ transformer.unembed_matrix(cfg, params)
        _close(full, jfull, "forward")
        logits, cache = model.prefill(params, {"tokens": t[:, :prompt]})
        _close(logits, full[:, prompt - 1], "prefill vs forward")
        cache = pad_cache_to(cache, S)
        for pos in range(prompt, S):
            lg, cache = model.decode_step(params, cache, t[:, pos:pos + 1],
                                          pos)
            _close(lg, full[:, pos], f"decode vs forward at {pos}")


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS_SHORT)
def test_generate_tokens_equal_jax(arch):
    jmodel, jparams, model, params = _both(arch, 6)
    prompt = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), 8)
    got = generate(model, params, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_failover_on_phi35_moe_smoke(capsys):
    state, log = train_main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
                             "--device", "cpu", "--dp", "4", "--fail-at",
                             "1", "--repair-at", "3", "--steps", "4",
                             "--seq-len", "32", "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [r["sync"] for r in log] == ["psum", "optcc", "optcc", "psum"]
    assert any("DEGRADED" in ln for ln in out)
    assert all(np.isfinite(r["loss"]) for r in log)
    assert state.params["blocks/router"].dtype == torch.float32
    assert state.params["blocks/e_gate"].shape == (2, 4, 64, 96)


@pytest.fixture(scope="module", params=ARCHS, ids=ARCH_IDS_SHORT)
def jax_dp_run(request, tmp_path_factory):
    arch = request.param
    out = tmp_path_factory.mktemp("jax") / "train_step.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "train_step", str(out), "--arch", arch], capture_output=True,
        text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return arch, dict(np.load(out))


@pytest.mark.parametrize("mode", ["healthy", "degraded"])
def test_dp_step_matches_jax(jax_dp_run, mode):
    """Three steps from the same JAX init on the same batches.

    The first step starts from equal parameters: its loss at the qwen3 DP
    test's 1e-5 (tests/test_torch_train_step.py), its grad norm at 2e-4
    and the parameters after it at the AdamW sign-flip bound of the hymba
    and internlm2 DP tests (each within 2 lr, at most 1e-3 of a leaf past
    1e-4). The MoE smoke runs are chaotic after that: the router's peaky
    gates (a capacity dispatch that moves whole tokens between experts)
    carry a rounding-sized difference into the later steps. Measured with
    tools/fp32_conditioning.py --perturb (the port's fp32 run against
    itself from an init nudged by about one fp32 rounding): phi35-moe's
    step-0 grad norm moves by 4.4e-5 (JAX's and the port's fp32 norms sit
    5.4e-5 and 7.9e-5 from float64), its third loss by 2.4e-4 and its
    third grad norm by 4.7e-2, and 41 % of its ln1 ends past 1e-4;
    arctic's third grad norm moves by 2.9e-3 and 1.4 % of its wq ends past
    1e-4. So the later losses are held at 1e-3, the later grad norms are
    not held, and the final parameters are held each within the sign-flip
    bound, 2 lr a step."""
    arch, ref = jax_dp_run
    fault = FaultState(drv.P) if mode == "healthy" else \
        FaultState(drv.P, *drv.DEGRADED)
    losses, gnorms, params = port_run(ref, fault, arch)
    np.testing.assert_allclose(losses[0], ref[f"{mode}/loss"][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], ref[f"{mode}/loss"][1:],
                               rtol=1e-3)
    np.testing.assert_allclose(gnorms[0], ref[f"{mode}/grad_norm"][0],
                               rtol=2e-4)
    _, _, first = port_run(ref, fault, arch, steps=1)
    for k, v in first.items():
        gap = np.abs(v - ref[f"{mode}/step1/params/{k}"])
        assert gap.max() <= 2 * drv.TRAIN_LR, (k, gap.max())
        assert (gap > 1e-4).sum() <= 1e-3 * gap.size, (k, (gap > 1e-4).sum())
    bound = 2 * drv.TRAIN_LR * drv.TRAIN_STEPS
    for k, v in params.items():
        gap = np.abs(v - ref[f"{mode}/params/{k}"])
        assert gap.max() <= bound, (k, gap.max())
