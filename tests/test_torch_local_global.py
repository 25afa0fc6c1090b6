"""gemma3's local:global attention in the port against the JAX package, on
the smoke config (6 layers, 5 local and 1 global, window 16) in fp32:
windowed chunked attention; forward, loss and gradients on the direct path
(S 24) and on the chunked windowed path (S 1040); prefill and decode
logits and every cache key (full caches and rings) past two ring wraps;
generate's tokens; the layer routing and the cache index maps. JAX's
parameters go through `convert.py`. The training side (the launcher and
the DP step) is tests/test_torch_local_global_dp.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro.train.serve import pad_cache_to as jax_pad_cache_to  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.train.serve import generate, pad_cache_to  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402

ARCH = "gemma3-27b"
TOL = 2e-4                  # serving, as tests/test_serve_equivalence.py
FP32_TOL = 1e-5             # attention, forward, loss and gradients


def _both(seed):
    """The JAX smoke model and its init, the port's model and the same
    parameters converted."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = build_model(get_config(ARCH, smoke=True))
    return jcfg, jmodel, jparams, model, params_from_numpy(
        flat_numpy(jparams), "cpu")


@pytest.mark.parametrize("window", [8, 24, 100])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 37)],
                         ids=["causal", "non-causal", "q_offset"])
def test_windowed_chunked_attention_matches_jax(window, causal, q_offset):
    """A ragged S of 200 in 16-query and 32-key blocks: 13 query blocks,
    7 key blocks, each query block visiting its n_rel key blocks."""
    B, S, H, KV, hd = 2, 200, 4, 2, 16
    rng = np.random.default_rng(window + q_offset)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S + q_offset, KV, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=32,
              q_offset=q_offset)
    want = np.asarray(jattn.chunked_attention(q, k, v, **kw))
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)
    if causal:
        # causal: the skipped blocks are fully masked, so the chunked path
        # equals direct attention
        direct = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, window=window,
                                     q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), direct.numpy(),
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("batch_size,seq_len", [(2, 24), (1, 1040)],
                         ids=["direct", "chunked"])
def test_forward_loss_and_grads_match_jax(batch_size, seq_len):
    """S 24 takes the direct path; S 1040 (> 1024) the chunked one, with
    the local layers' window of 16 skipping key blocks."""
    jcfg, jmodel, jparams, model, params = _both(0)
    rng = np.random.default_rng(seq_len)
    tokens = rng.integers(0, jcfg.vocab_size, (batch_size, seq_len + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -100
    jb = jax.tree.map(jnp.asarray, batch)
    jh = jax.jit(lambda p, t: jtransformer.forward(jcfg, p, t))(
        jparams, jb["tokens"])
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
    jgrads = flat_numpy(jgrads)

    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        h = transformer.forward(model.cfg, params, tb["tokens"])
    # the final norm's output, up to ~4 in size: within 1e-5 of the
    # largest (fp32 sums in XLA's and PyTorch's orders, over 6 layers)
    jh = np.asarray(jh)
    np.testing.assert_allclose(h.numpy(), jh, rtol=FP32_TOL,
                               atol=FP32_TOL * np.abs(jh).max())
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=FP32_TOL)
    assert sorted(jgrads) == sorted(params)
    for key, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[key], rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=key)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("prompt", [12, 20], ids=["short", "wrapped"])
def test_prefill_and_decode_match_jax_past_two_ring_wraps(prompt):
    """Prompt 12 < window 16 leaves the rings part filled; prompt 20 wraps
    them in the prefill. Decoding to 40 wraps them twice more. Every step's
    logits and all four cache keys equal JAX's."""
    B, total = 2, 40
    _, jmodel, jparams, model, params = _both(1)
    toks = np.random.default_rng(prompt).integers(
        0, model.cfg.vocab_size, (B, total)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :prompt])})
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :prompt]).long()})
    assert sorted(cache) == sorted(jcache) == ["k_glob", "k_loc", "v_glob",
                                               "v_loc"]
    _close(logits, jlogits, "prefill logits")
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close(cache[key], jcache[key], f"prefill cache {key}")
    jcache, cache = jax_pad_cache_to(jcache, total), pad_cache_to(cache, total)
    assert cache["k_loc"].shape[2] == model.cfg.local_window
    jstep = jax.jit(jmodel.decode_step)
    for pos in range(prompt, total):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(tok).long(), pos)
        _close(lg, jlg, f"decode logits at {pos}")
        for key in cache:
            _close(cache[key], jcache[key], f"cache {key} at {pos}")


def test_generate_tokens_equal_jax():
    _, jmodel, jparams, model, params = _both(2)
    prompt = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 20)).astype(np.int32)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), 12)
    got = generate(model, params, torch.from_numpy(prompt).long(), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_layer_routing_and_cache_maps_match_jax(smoke):
    jcfg, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke)
    is_glob = transformer.layer_is_global(cfg)
    np.testing.assert_array_equal(is_glob,
                                  jtransformer.layer_is_global(jcfg))
    for ours, theirs in zip(transformer._cache_index_maps(cfg),
                            jtransformer._cache_index_maps(jcfg)):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    if not smoke:
        assert int(is_glob.sum()) == 10 and int((~is_glob).sum()) == 52
        return
    cache = transformer.init_cache(cfg, 2, 8, "cpu")
    jshapes = {k: v.shape for k, v in
               jtransformer.init_cache(jcfg, 2, 8).items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == jshapes


def test_ring_decode_equals_windowed_attention_over_the_linear_cache():
    """Position p at ring slot p % w, attended over min(pos + 1, w) slots
    without a mask, equals the windowed causal attention of the newest
    query over the whole sequence, before, at and after the wraps."""
    B, H, KV, hd, w = 2, 4, 2, 16, 8
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, 3 * w, KV, hd)).astype(np.float32)) for _ in range(2))
    ring_k, ring_v = torch.zeros((B, w, KV, hd)), torch.zeros((B, w, KV, hd))
    for pos in range(3 * w):
        ring_k[:, pos % w], ring_v[:, pos % w] = k[:, pos], v[:, pos]
        q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(
            np.float32))
        got = tattn.ring_decode_attention(q, ring_k, ring_v,
                                          min(pos + 1, w))
        want = flash_attention_ref(q, k, v, causal=True, window=w,
                                   q_offset=pos, kv_len=pos + 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"pos {pos}")
