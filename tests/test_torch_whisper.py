"""whisper-base (bidirectional encoder over stubbed audio frames, causal
decoder with cross-attention) in the port against the JAX package, on its
smoke config (2 + 2 layers, d 64, 4/4 heads of head dim 16, 24 frames,
fp32). Parameters come from the JAX `init` through `convert.py`; frames
are standard normal, as tests/test_arch_smoke.py draws them. Loss and
every gradient leaf; the encoder states; prefill logits and every cache
leaf (k, v, xk, xv); every greedy decode step's logits, against JAX's
decode and JAX's and the port's teacher-forced forward; the tokens of
`generate` with the frames in `batch_extras`; the cross-attention of bf16
queries over fp32 encoder states; the bf16 tree's paths and dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro.train.serve import pad_cache_to as jax_pad_cache_to  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention, build_model, whisper  # noqa: E402
from repro_torch.train.serve import generate, pad_cache_to  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402

ARCH = "whisper-base"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
SERVE_TOL = 2e-4                  # tests/test_serve_equivalence.py


def _both(seed):
    jmodel = jax_build_model(jax_get_config(ARCH, smoke=True))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = build_model(get_config(ARCH, smoke=True))
    return jmodel, jparams, model, params_from_numpy(flat_numpy(jparams),
                                                     "cpu")


def _frames(cfg, seed, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=SERVE_TOL,
                               atol=SERVE_TOL, err_msg=what)


def _close_normwise(got, want, what):
    """A cache leaf within SERVE_TOL of its norm: the smoke init (scale
    1/sqrt(L) = 0.71 on d x d weights) amplifies each projection ~6x, so
    the decoder's k / v reach ~10 and two fp32 runs part by up to 2.6e-4
    in an element near 0; the logits read from them are held elementwise
    (`_close`)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    gap = np.linalg.norm(got - want)
    assert gap <= SERVE_TOL * np.linalg.norm(want), (what, gap)


def test_loss_and_grads_match_jax():
    cfg = get_config(ARCH, smoke=True)
    jmodel, jparams, model, params = _both(0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 25))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32),
             "frames": _frames(cfg, 1)}
    batch["labels"][0, :3] = -100                    # masked positions
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    for t in params.values():
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch.update(tokens=tbatch["tokens"].long(),
                  labels=tbatch["labels"].long())
    loss = model.loss(params, tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    jgrads = flat_numpy(jgrads)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert sorted(jgrads) == sorted(params)
    assert any(k.startswith("enc_blocks/") for k in params)
    # norm-wise per leaf, as tests/test_torch_dense_configs.py holds them;
    # whisper-smoke's are worse conditioned than the dense configs': against
    # a float64 run of the port, JAX's fp32 gradients are up to 4.1e-4 of a
    # leaf's norm off (enc_blocks/ln1) and the port's up to 2.1e-4
    # (tools/fp32_conditioning.py --arch whisper-base --jax), so two fp32
    # runs are held to 1e-3, 10 GRAD_TOL
    for key, g in zip(params, grads):
        want = jgrads[key]
        gap = np.linalg.norm(g.numpy() - want)
        assert gap <= 10 * GRAD_TOL * np.linalg.norm(want), (key, gap)


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
def test_encoder_matches_jax(serving):
    """The encoder states, through the training attention and through the
    serving one (the flash op's plain version here)."""
    jmodel, jparams, model, params = _both(2)
    frames = _frames(model.cfg, 2)
    want = jax.jit(lambda p, f: jax_whisper.encode(jmodel.cfg, p, f))(
        jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = whisper.encode(model.cfg, params, torch.from_numpy(frames),
                             serving=serving)
    _close(got, want, "encoder states")


def test_prefill_and_decode_match_jax():
    """Prefill 12 tokens over the frames, then decode to 20: the prefill's
    logits and every cache leaf, each step's logits (also against the
    teacher-forced forward, JAX's and the port's), and the caches at the
    end equal JAX's; the self cache is padded to the decode budget, the
    cross cache is not."""
    B, prompt, total = 2, 12, 20
    jmodel, jparams, model, params = _both(5)
    cfg = model.cfg
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, total)).astype(np.int32)
    frames = _frames(cfg, 5, B)
    jfull = jnp.einsum("bsd,dv->bsv", jax.jit(
        lambda p, t, f: jax_whisper.forward(jmodel.cfg, p, t, f))(
            jparams, jnp.asarray(toks), jnp.asarray(frames)),
        jparams["lm_head"])
    with torch.no_grad():
        full = whisper.forward(cfg, params, torch.from_numpy(toks).long(),
                               torch.from_numpy(frames)) @ params["lm_head"]
    _close(full, jfull, "forward")
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :prompt]),
                  "frames": jnp.asarray(frames)})
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, :prompt]).long(),
                     "frames": torch.from_numpy(frames)})
    _close(logits, jlogits, "prefill logits")
    assert sorted(cache) == sorted(jcache) == ["k", "v", "xk", "xv"]
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close_normwise(cache[key], jcache[key], f"prefill cache {key}")
    keys = ("k", "v")
    jcache = jax_pad_cache_to(jcache, total, keys=keys)
    cache = pad_cache_to(cache, total, keys=keys)
    assert cache["k"].shape[2] == total
    assert cache["xk"].shape[2] == cfg.n_audio_frames
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
        _close_normwise(cache[key], jcache[key], f"cache {key} at the end")


def test_generate_tokens_equal_jax():
    jmodel, jparams, model, params = _both(6)
    prompt = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 4)).astype(np.int32)
    frames = _frames(model.cfg, 6)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), 10,
                        batch_extras={"frames": jnp.asarray(frames)})
    got = generate(model, params, torch.from_numpy(prompt).long(), 10,
                   {"frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Sq", [1, 4])
def test_cross_attention_widens_bf16_queries_to_fp32_states(Sq):
    """fp32 frames promote the JAX encoder (and so xk, xv) to fp32 beside
    a bf16 decoder; JAX's attention softmaxes in fp32 and returns q's
    dtype. `full_attention` widens q (exact) for one fp32 call: equal to
    JAX's within one bf16 rounding of the output (2^-8 relative)."""
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
            for _ in range(2))
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = jax_attn.attention(jq, jnp.asarray(k), jnp.asarray(v),
                              causal=False)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = attention.full_attention(tq, torch.from_numpy(k),
                                   torch.from_numpy(v))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -8,
                               atol=2 ** -8)


def test_bf16_params_have_the_jax_paths_shapes_and_dtypes():
    jcfg = jax_get_config(ARCH, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = flat_numpy(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16",
                                               compute_dtype="bfloat16")
    ours = build_model(cfg).init(0, "cpu")
    assert list(ours) == sorted(tree)
    for k, v in ours.items():
        assert tuple(v.shape) == tree[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(tree[k].dtype), k
