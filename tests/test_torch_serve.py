"""The port's serving path against the JAX package, for the smoke configs
of both ported families: parameters from the JAX `init` go through
`convert.py`; then prefill logits, every decode step's logits and cache,
and the greedy tokens of `generate` are held against JAX's (2e-4, as
tests/test_serve_equivalence.py). For rwkv6 the JAX side runs both its
scan and its Pallas wkv kernel (interpret mode). Also: decode matches the
port's own forward, `pad_cache_to`, the launcher on the CPU, and on the
card the same run against the CPU's. JAX is imported by a fixture, so the
card test also runs where JAX is not installed."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import build_model, rwkv6, transformer  # noqa: E402
from repro_torch.train.serve import (generate, make_serve_step,  # noqa: E402
                                     pad_cache_to)
from jax_reference import flat_numpy  # noqa: E402

TOL = 2e-4
B, PROMPT, TOTAL = 2, 12, 20
# (arch, JAX rwkv6 runs its Pallas wkv kernel)
CASES = [("qwen3-1.7b", False), ("rwkv6-7b", False), ("rwkv6-7b", True)]
IDS = ["qwen3", "rwkv6-scan", "rwkv6-wkv-kernel"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces that the parity tests call."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.train.serve import generate, pad_cache_to
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 get_config=jax_get_config,
                                 build_model=jax_build_model,
                                 generate=generate,
                                 pad_cache_to=pad_cache_to)


def _setup(jx, arch, jax_kernel, seed=1):
    jcfg = jx.get_config(arch, smoke=True).replace(use_wkv_kernel=jax_kernel)
    jmodel = jx.build_model(jcfg)
    jparams = jx.jax.jit(jmodel.init)(jx.jax.random.PRNGKey(seed))
    model = build_model(get_config(arch, smoke=True))
    params = params_from_numpy(flat_numpy(jparams), "cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, TOTAL)).astype(np.int32)
    return jmodel, jparams, model, params, toks


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch,jax_kernel", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(jx, arch, jax_kernel):
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, model, params, toks = _setup(jx, arch, jax_kernel)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :PROMPT]).long()})
    _close(logits, jlogits, "prefill logits")
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        _close(cache[key], jcache[key], f"prefill cache {key}")

    jcache = jx.pad_cache_to(jcache, TOTAL)
    cache = pad_cache_to(cache, TOTAL)
    jstep = jax.jit(jmodel.decode_step)
    for pos in range(PROMPT, TOTAL):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(tok).long(), pos)
        _close(lg, jlg, f"decode logits at {pos}")
        for key in cache:
            _close(cache[key], jcache[key], f"cache {key} at {pos}")


@pytest.mark.parametrize("arch,jax_kernel", CASES, ids=IDS)
def test_generate_tokens_equal_jax(jx, arch, jax_kernel):
    jmodel, jparams, model, params, toks = _setup(jx, arch, jax_kernel,
                                                  seed=2)
    want = jx.generate(jmodel, jparams, jx.jnp.asarray(toks[:, :PROMPT]), 6)
    got = generate(model, params, torch.from_numpy(toks[:, :PROMPT]).long(),
                   6)
    assert got.shape == (B, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rwkv6_prefill_state_at_a_ragged_chunk_matches_jax_kernel_path(jx):
    """With S > ssm_chunk and S not a multiple of it, the JAX scan path
    zero-pads the sequence and returns an all-zero wkv state (its padded
    steps have w = 0); the JAX wkv-kernel path does not pad. The port's
    prefill state equals the kernel path's."""
    jcfg = jx.get_config("rwkv6-7b", smoke=True).replace(ssm_chunk=8)
    jmodel = jx.build_model(jcfg.replace(use_wkv_kernel=True))
    jparams = jx.jax.jit(jmodel.init)(jx.jax.random.PRNGKey(1))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, PROMPT))
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jx.jnp.asarray(toks)})
    model = build_model(get_config("rwkv6-7b", smoke=True))
    params = params_from_numpy(flat_numpy(jparams), "cpu")
    logits, cache = model.prefill(params,
                                  {"tokens": torch.from_numpy(toks).long()})
    assert float(np.abs(np.asarray(jcache["wkv"])).max()) > 1.0
    _close(logits, jlogits, "prefill logits")
    for key in cache:
        _close(cache[key], jcache[key], f"prefill cache {key}")


def _forward_logits(cfg, params, tokens):
    if cfg.family == "rwkv6":
        return rwkv6.forward(cfg, params, tokens).float() \
            @ params["lm_head"].float()
    return transformer.forward(cfg, params, tokens).float() \
        @ transformer.unembed_matrix(cfg, params).float()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_decode_matches_forward(arch):
    """Prefill the first half and decode the rest token by token: the
    logits equal the teacher-forced forward's at the same positions
    (test_decode_matches_forward of the JAX package, for the port)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, TOTAL))).long()
    with torch.no_grad():
        full = _forward_logits(cfg, params, toks)
        logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]})
        _close(logits, _np(full[:, PROMPT - 1]), "prefill vs forward")
        cache = pad_cache_to(cache, TOTAL)
        for pos in range(PROMPT, TOTAL):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, pos:pos + 1], pos)
            _close(lg, _np(full[:, pos]), f"decode vs forward at {pos}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_serve_step_is_the_argmax_of_decode_step(arch):
    model = build_model(get_config(arch, smoke=True))
    params = model.init(4, "cpu")
    prompt = torch.arange(10).reshape(2, 5)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": prompt})
        cache = pad_cache_to(cache, 6)
        twin = {k: v.clone() for k, v in cache.items()}
        nxt, _ = make_serve_step(model)(params, cache, prompt[:, -1:], 5)
        logits, _ = model.decode_step(params, twin, prompt[:, -1:], 5)
    assert nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1))


def test_pad_cache_to_grows_only_full_sequence_caches():
    kv = torch.ones((2, 3, 5, 2, 4))
    state = torch.ones((2, 3, 4, 4, 4))
    out = pad_cache_to({"k_glob": kv, "v_glob": kv, "wkv": state}, 9)
    assert out["k_glob"].shape == (2, 3, 9, 2, 4)
    assert torch.equal(out["v_glob"][:, :, :5], kv)
    assert not out["v_glob"][:, :, 5:].any()
    assert out["wkv"] is state
    assert pad_cache_to({"k_glob": kv}, 4)["k_glob"] is kv


def test_rwkv6_params_convert_one_to_one_with_per_leaf_dtypes(jx):
    """bf16 rwkv6: every leaf of the JAX init converts bit-exactly, the
    fp32 leaves (w_base, bonus) stay fp32, and the port's own init has the
    same paths, order, shapes and dtypes."""
    jcfg = jx.get_config("rwkv6-7b", smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = flat_numpy(jx.jax.jit(jx.build_model(jcfg).init)(
        jx.jax.random.PRNGKey(4)))
    params = params_from_numpy(tree, "cpu")
    assert params["blocks/w_base"].dtype == torch.float32
    assert params["blocks/bonus"].dtype == torch.float32
    assert params["blocks/wr"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    cfg = get_config("rwkv6-7b", smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    ours = build_model(cfg).init(0, "cpu")
    assert list(ours) == list(tree)
    for k, v in ours.items():
        assert tuple(v.shape) == tree[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(tree[k].dtype), k


def test_rwkv6_training_is_not_ported_yet():
    model = build_model(get_config("rwkv6-7b", smoke=True))
    with pytest.raises(NotImplementedError, match="wkv"):
        model.loss({}, {})


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_launch_serve_on_cpu(arch):
    tokens, log = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8",
                              "--new-tokens", "5", "--seed", "3"])
    cfg = get_config(arch, smoke=True)
    assert tokens.shape == (2, 5)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size
    assert log["n_layers"] == cfg.n_layers and log["peak_gib"] is None
    assert log["prefill_seconds"] > 0 and log["decode_seconds"] > 0
    # the CPU path never launches a kernel
    assert all(v == 0 for v in log["launches"].values())
    again, _ = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "5", "--seed", "3"])
    assert torch.equal(tokens, again)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_cuda_serve_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(3, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, PROMPT))).long()
    want = generate(model, params, prompt, 8)
    tokens, log = serve_main(["--arch", arch, "--smoke", "--batch", "2",
                              "--prompt-len", "8", "--new-tokens", "4"])
    assert tokens.is_cuda and all(v > 0 for k, v in log["launches"].items()
                                  if k == ("wkv" if arch == "rwkv6-7b"
                                           else "flash_attention"))
    cuda_params = {k: v.cuda() for k, v in params.items()}
    got = generate(model, cuda_params, prompt.cuda(), 8)
    assert torch.equal(got.cpu(), want)
