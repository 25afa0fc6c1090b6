"""The port's dense model against the JAX model: loss and every gradient
leaf from the same parameters (JAX init, converted) and the same batch, in
fp32; the long-sequence attention path; the weight conversion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro.optim import update as jax_update  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 opt_state_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import build_model  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402

# tiny config whose 1100-token sequence takes the chunked attention path
LONG = dict(name="tiny-long", family="dense", n_layers=1, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, head_dim=16,
            qk_norm=True, tie_embeddings=True, param_dtype="float32",
            compute_dtype="float32", logits_chunk=128)


def _loss_and_grads_both(jcfg, cfg, seq_len, batch_size=2, seed=0):
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (batch_size, seq_len + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -100                    # masked positions
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, batch))

    model = build_model(cfg)
    params = params_from_numpy(flat_numpy(jparams), "cpu")
    for t in params.values():
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss = model.loss(params, tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(jloss), flat_numpy(jgrads),
            float(loss.detach()), dict(zip(params, grads)))


def _check(jloss, jgrads, loss, grads):
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert sorted(jgrads) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_qwen3_smoke_loss_and_grads_match_jax():
    jcfg = jax_get_config("qwen3-1.7b", smoke=True)
    cfg = get_config("qwen3-1.7b", smoke=True)
    assert cfg.param_dtype == "float32" and cfg.qk_norm
    _check(*_loss_and_grads_both(jcfg, cfg, seq_len=40))


def test_long_sequence_chunked_attention_matches_jax():
    jcfg, cfg = JaxModelConfig(**LONG), ModelConfig(**LONG)
    _check(*_loss_and_grads_both(jcfg, cfg, seq_len=1100, batch_size=1))


def test_param_layout_and_count_match_jax_init():
    jcfg = jax_get_config("qwen3-1.7b", smoke=True)
    jparams = flat_numpy(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    model = build_model(get_config("qwen3-1.7b", smoke=True))
    ours = model.init(0, "cpu")
    assert list(ours) == list(jparams)               # same paths, same order
    for k, v in ours.items():
        assert tuple(v.shape) == jparams[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(jparams[k].dtype)
    assert model.param_count(ours) == sum(a.size for a in jparams.values())


def test_convert_round_trip_is_bit_exact_bf16_included():
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(
        param_dtype="bfloat16")
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(3))
    opt = JaxAdamWConfig(moment_dtype="bfloat16")
    jstate = jax_init_state(jparams, opt)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, jparams)
    _, jstate, _ = jax.jit(lambda p, g, s: jax_update(p, g, s, 1e-3, opt))(
        jparams, grads, jstate)
    for tree, to_t, to_np in (
            (flat_numpy(jparams), params_from_numpy, params_to_numpy),
            (flat_numpy(jstate), opt_state_from_numpy, opt_state_to_numpy)):
        converted = to_t(tree, "cpu")
        back = to_np(converted)
        assert sorted(back) == sorted(tree)
        for k, v in tree.items():
            assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
            assert back[k].tobytes() == v.tobytes(), k
    state = opt_state_from_numpy(flat_numpy(jstate), "cpu")
    assert state["mu"]["embed"].dtype == torch.bfloat16
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 1


def test_configs_of_later_slices_raise():
    ported = ("qwen3-1.7b", "rwkv6-7b")
    assert set(ported) <= set(ARCH_IDS) and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        if arch not in ported:
            with pytest.raises(NotImplementedError, match="later|slice"):
                get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError):
        build_model(get_config("qwen3-1.7b").replace(n_experts=4))
