"""The port's AdamW and LR schedules against the JAX ones on the same
parameters, gradients and state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 opt_state_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.optim import schedules  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402

SHAPES = {"a": (7, 5), "b/w": (3, 4, 6), "b/z": (11,)}


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    flat = {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}
    return flat, {"a": jnp.asarray(flat["a"]),
                  "b": {"w": jnp.asarray(flat["b/w"]),
                        "z": jnp.asarray(flat["b/z"])}}


def _run_both(jcfg, cfg, grad_scale, lr=1e-3, warm_steps=2):
    """Warm the JAX state up for a few steps (non-zero moments, count > 1),
    then take one more step in both packages from that same state."""
    _, params = _tree(0, 1.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    state = jopt.init_state(params, jcfg)
    jupd = jax.jit(lambda p, g, s: jopt.update(p, g, s, lr, jcfg))
    for i in range(warm_steps):
        params, state, _ = jupd(params, _tree(10 + i, grad_scale)[1], state)
    gflat, grads = _tree(99, grad_scale)
    tp = params_from_numpy(flat_numpy(params), "cpu")
    ts = opt_state_from_numpy(flat_numpy(state), "cpu")
    tg = params_from_numpy(gflat, "cpu")
    jp, js, jn = jupd(params, grads, state)
    tp2, ts2, tn = optim.update(tp, tg, ts, lr, cfg)
    assert tp2 is tp and ts2 is ts                  # updated in place
    return (flat_numpy(jp), flat_numpy(js), float(jn),
            params_to_numpy(tp), opt_state_to_numpy(ts), float(tn))


def test_adamw_update_with_clipping_matches_jax():
    cfg = jopt.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    jp, js, jn, tp, ts, tn = _run_both(
        cfg, optim.AdamWConfig(weight_decay=0.1, clip_norm=1.0), 10.0)
    assert jn > cfg.clip_norm                       # clipping is active
    assert tn == pytest.approx(jn, rel=1e-6)
    # same fp32 operations in the same order; pow, sqrt and the norm's
    # summation order may differ in the last bit
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-10,
                                   err_msg=k)
    assert ts["count"] == js["count"] == 3


def test_adamw_bf16_moments_match_jax():
    jp, js, jn, tp, ts, tn = _run_both(
        jopt.AdamWConfig(moment_dtype="bfloat16"),
        optim.AdamWConfig(moment_dtype="bfloat16"), 0.1)
    assert tn == pytest.approx(jn, rel=1e-6)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    for k in js:
        if k == "count":
            continue
        assert ts[k].dtype == js[k].dtype and str(ts[k].dtype) == "bfloat16"
        # an fp32 value a bit away from JAX's may round to the next bf16
        np.testing.assert_allclose(ts[k].astype(np.float32),
                                   js[k].astype(np.float32), rtol=2 ** -7,
                                   atol=1e-12, err_msg=k)


def test_global_norm_matches_jax():
    flat, tree = _tree(5, 3.0)
    got = optim.global_norm(params_from_numpy(flat, "cpu"))
    assert float(got) == pytest.approx(float(jopt.global_norm(tree)),
                                       rel=1e-6)


@pytest.mark.parametrize("args", [(1.0, 10, 50, 40), (1e-2, 20, 100, 40),
                                  (3e-4, 0, 5, 0)])
def test_warmup_stable_decay_matches_jax(args):
    ours, ref = schedules.warmup_stable_decay(*args), \
        jsched.warmup_stable_decay(*args)
    for step in (0, 1, 5, 10, 19, 20, 21, 60, 100, 119, 120, 121, 140,
                 160, 200, 1000):
        got, want = ours(step), ref(step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=0.0)


def test_constant_schedule_matches_jax():
    ours, ref = schedules.constant(2.5e-4), jsched.constant(2.5e-4)
    for step in (0, 7):
        assert float(ours(step)) == float(ref(step))
