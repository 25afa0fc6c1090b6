"""The port's serving path against the JAX package, for the smoke configs
of the served archs (qwen3, gemma3 with its rolling local caches, rwkv6;
hymba's and whisper's JAX parity is tests/test_torch_{hymba,whisper}.py,
the MoE configs' tests/test_torch_moe.py):
parameters from the JAX `init` go through `convert.py`; then prefill
logits, every decode step's logits and cache, and the greedy tokens of
`generate` are held against JAX's (2e-4, as
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
from repro_torch.models import (build_model, hymba, rwkv6,  # noqa: E402
                                transformer, whisper)
from repro_torch.train.serve import (generate, make_serve_step,  # noqa: E402
                                     pad_cache_to)
from jax_reference import flat_numpy  # noqa: E402

TOL = 2e-4
B, PROMPT, TOTAL = 2, 12, 20
# (arch, JAX rwkv6 runs its Pallas wkv kernel)
CASES = [("qwen3-1.7b", False), ("gemma3-27b", False), ("rwkv6-7b", False),
         ("rwkv6-7b", True)]
IDS = ["qwen3", "gemma3", "rwkv6-scan", "rwkv6-wkv-kernel"]
# the smoke configs of the served archs (gemma3's and hymba's windows of
# 16 wrap their rings before TOTAL; minicpm, qwen2-vl and hymba have head
# dim 12; whisper's prefill takes frames); the JAX parity of internlm2,
# minicpm and qwen2-vl is tests/test_torch_dense_configs.py, of the MoE
# configs tests/test_torch_moe.py
ARCHS = ["qwen3-1.7b", "gemma3-27b", "rwkv6-7b", "internlm2-1.8b",
         "minicpm-2b", "qwen2-vl-2b", "hymba-1.5b", "whisper-base",
         "phi3.5-moe-42b-a6.6b", "arctic-480b"]


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


def _extras(cfg, seed=7):
    """The prefill batch's extras: whisper's frames (standard normal, as
    tests/test_arch_smoke.py draws them), none for the others."""
    if cfg.family != "whisper":
        return {}
    return {"frames": torch.from_numpy(np.random.default_rng(seed)
                                       .standard_normal((B, cfg.n_audio_frames,
                                                         cfg.d_model))
                                       .astype(np.float32))}


def _forward_logits(cfg, params, tokens, extras):
    if cfg.family == "rwkv6":
        h = rwkv6.forward(cfg, params, tokens)
    elif cfg.family == "hymba":
        h = hymba.forward(cfg, params, tokens)
    elif cfg.family == "whisper":
        h = whisper.forward(cfg, params, tokens, extras["frames"])
    else:
        return transformer.forward(cfg, params, tokens).float() \
            @ transformer.unembed_matrix(cfg, params).float()
    return h.float() @ params["lm_head"].float()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill the first half and decode the rest token by token: the
    logits equal the teacher-forced forward's at the same positions
    (test_decode_matches_forward of the JAX package, for the port). As
    there, an MoE config runs at capacity factor 8: capacity drops depend
    on the sequence length the router sees, so prefill(S/2) and forward(S)
    legitimately differ under drops."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, TOTAL))).long()
    extras = _extras(cfg)
    with torch.no_grad():
        full = _forward_logits(cfg, params, toks, extras)
        logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT],
                                               **extras})
        _close(logits, _np(full[:, PROMPT - 1]), "prefill vs forward")
        cache = pad_cache_to(cache, TOTAL, keys=_pad_keys(cfg))
        for pos in range(PROMPT, TOTAL):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, pos:pos + 1], pos)
            _close(lg, _np(full[:, pos]), f"decode vs forward at {pos}")


def _pad_keys(cfg):
    return ("k", "v") if cfg.family == "whisper" else None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_is_the_argmax_of_decode_step(arch):
    model = build_model(get_config(arch, smoke=True))
    params = model.init(4, "cpu")
    prompt = torch.arange(10).reshape(2, 5)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": prompt,
                                          **_extras(model.cfg)})
        cache = pad_cache_to(cache, 6, keys=_pad_keys(model.cfg))
        twin = {k: v.clone() for k, v in cache.items()}
        nxt, _ = make_serve_step(model)(params, cache, prompt[:, -1:], 5)
        logits, _ = model.decode_step(params, twin, prompt[:, -1:], 5)
    assert nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1))


def test_pad_cache_to_grows_only_full_sequence_caches():
    kv = torch.ones((2, 3, 5, 2, 4))
    state = torch.ones((2, 3, 4, 4, 4))
    ring = torch.ones((4, 3, 4, 2, 4))
    out = pad_cache_to({"k_glob": kv, "v_glob": kv, "wkv": state,
                        "k_loc": ring, "v_loc": ring}, 9)
    assert out["k_glob"].shape == (2, 3, 9, 2, 4)
    assert torch.equal(out["v_glob"][:, :, :5], kv)
    assert not out["v_glob"][:, :, 5:].any()
    assert out["wkv"] is state
    assert out["k_loc"] is ring and out["v_loc"] is ring
    assert pad_cache_to({"k_glob": kv}, 4)["k_glob"] is kv


def test_pad_cache_to_grows_only_the_named_keys():
    """whisper pads its self cache "k" / "v" and never its cross cache;
    hymba's "k" / "v" rings, conv and ssm states are not named by
    default, so they never grow."""
    self_kv = torch.ones((2, 3, 5, 2, 4))
    cross = torch.ones((2, 3, 24, 2, 4))
    out = pad_cache_to({"k": self_kv, "v": self_kv, "xk": cross,
                        "xv": cross}, 9, keys=("k", "v"))
    assert out["k"].shape == (2, 3, 9, 2, 4) and out["xk"] is cross
    assert torch.equal(out["v"][:, :, :5], self_kv)
    ring, conv = torch.ones((2, 3, 16, 2, 4)), torch.ones((2, 3, 3, 8))
    out = pad_cache_to({"k": ring, "v": ring, "conv": conv}, 40)
    assert out["k"] is ring and out["v"] is ring and out["conv"] is conv


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


@pytest.mark.parametrize("arch", ARCHS)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_serve_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(3, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, PROMPT))).long()
    extras = _extras(cfg)
    want = generate(model, params, prompt, 8, extras)
    tokens, log = serve_main(["--arch", arch, "--smoke", "--batch", "2",
                              "--prompt-len", "8", "--new-tokens", "4"])
    # one kernel launch per layer in the prefill and each decode step; for
    # the transformers and hymba any of the flash routes (this 8-token
    # prompt of 2 heads per kv head is 16 rows: flash_decode's); whisper
    # also one per encoder layer and a cross-attention per decoder layer
    # in the prefill and each step
    names = (("wkv",) if arch == "rwkv6-7b" else
             ("flash_attention", "flash_prefill", "flash_decode"))
    per_call = 2 if cfg.family == "whisper" else 1
    assert tokens.is_cuda and sum(log["launches"][k] for k in names) \
        == cfg.n_layers * 4 * per_call + cfg.encoder_layers
    cuda_params = {k: v.cuda() for k, v in params.items()}
    got = generate(model, cuda_params, prompt.cuda(), 8,
                   {k: v.cuda() for k, v in extras.items()})
    assert torch.equal(got.cpu(), want)
