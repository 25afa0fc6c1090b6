"""The port's wkv op against the JAX Pallas kernel (interpret mode) on the
same seeded inputs: the JAX kernel tests' sweep, an initial state, state
chaining over two calls and over one-token calls (the decode path); the
CUDA kernel against its plain version on the card. JAX is imported by a
fixture, so the card test also runs where JAX is not installed. Limit
1e-5 relative + absolute, as the JAX wkv tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.wkv import kernel, ops, ref  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, the Pallas wkv kernel)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.wkv.kernel import wkv_pallas
    return jnp, wkv_pallas


def _inputs(seed, B, S, H, hd, w_lo=0.2):
    rng = np.random.default_rng(seed)
    r, k, v = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3)]
    w = rng.uniform(w_lo, 0.99, (B, S, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    return r, k, v, w, u


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(1, 16, 2, 8), (2, 33, 3, 16),
                                   (1, 64, 1, 32)])
def test_plain_matches_jax_wkv_kernel(jx, shape):
    jnp, pallas = jx
    arrays = _inputs(sum(shape), *shape)
    want_out, want_state = pallas(*map(jnp.asarray, arrays), interpret=True)
    out, state = ops.wkv(*_t(arrays))
    assert out.shape == shape and state.shape == shape[:1] + (
        shape[2], shape[3], shape[3])
    _close(out, want_out)
    _close(state, want_state)


def test_initial_state_matches_jax_wkv_kernel(jx):
    """A nonzero state0 goes in as the JAX kernel takes it (the jnp
    `wkv_ref` of the JAX package drops state0, so the kernel is the
    reference here)."""
    jnp, pallas = jx
    B, S, H, hd = 2, 12, 2, 8
    arrays = _inputs(5, B, S, H, hd)
    s0 = np.random.default_rng(6).standard_normal(
        (B, H, hd, hd)).astype(np.float32)
    want_out, want_state = pallas(*map(jnp.asarray, arrays),
                                  state0=jnp.asarray(s0), interpret=True)
    out, state = ops.wkv(*_t(arrays), torch.from_numpy(s0))
    _close(out, want_out)
    _close(state, want_state)


def test_state_chaining_matches_jax(jx):
    """Two calls chained through the state equal one call, on both sides
    (test_wkv_state_chaining's property)."""
    jnp, pallas = jx
    B, S, H, hd = 1, 32, 2, 8
    r, k, v, w, u = _inputs(0, B, S, H, hd, w_lo=0.5)
    jr, jk, jv, jw, ju = map(jnp.asarray, (r, k, v, w, u))
    _, jst1 = pallas(jr[:, :16], jk[:, :16], jv[:, :16], jw[:, :16], ju,
                     interpret=True)
    jh2, jst2 = pallas(jr[:, 16:], jk[:, 16:], jv[:, 16:], jw[:, 16:], ju,
                       state0=jst1, interpret=True)
    tr, tk, tv, tw, tu = _t((r, k, v, w, u))
    full, st_full = ops.wkv(tr, tk, tv, tw, tu)
    _, st1 = ops.wkv(tr[:, :16], tk[:, :16], tv[:, :16], tw[:, :16], tu)
    h2, st2 = ops.wkv(tr[:, 16:].contiguous(), tk[:, 16:].contiguous(),
                      tv[:, 16:].contiguous(), tw[:, 16:].contiguous(), tu,
                      st1)
    _close(h2, jh2)
    _close(st2, jst2)
    _close(h2, full[:, 16:].numpy())
    _close(st2, st_full.numpy())


def test_one_token_calls_equal_one_call(jx):
    """The decode path: S calls of one token, each from the last state,
    equal one call over the sequence (and the JAX kernel)."""
    jnp, pallas = jx
    arrays = _inputs(9, 2, 10, 3, 16)
    want_out, want_state = pallas(*map(jnp.asarray, arrays), interpret=True)
    r, k, v, w, u = _t(arrays)
    state, outs = None, []
    for t in range(r.shape[1]):
        o, state = ops.wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                           w[:, t:t + 1], u, state)
        outs.append(o)
    _close(torch.cat(outs, 1), want_out)
    _close(state, want_state)


def test_op_refuses_what_it_does_not_run():
    r, k, v, w, u = _t(_inputs(1, 1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="backward"):
        ops.wkv(r.requires_grad_(), k, v, w, u)
    r = r.detach()
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wkv(*(t.to("meta") for t in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv_cuda(r, k, v, w, u)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    # every head dim: one token, prompts around 16 tokens, past one staged
    # chunk (33 > WKV_CHUNK) and long; and the JAX sweep's shapes
    shapes = [(2, S, 3, hd) for hd in kernel.HEAD_DIMS
              for S in (1, 15, 16, 17, 33, 1024)]
    for shape in shapes + [(1, 16, 2, 8), (2, 33, 3, 16), (1, 64, 1, 32),
                           (2, 40, 4, 64)]:
        r, k, v, w, u = (t.cuda() for t in _t(_inputs(sum(shape), *shape)))
        B, S, H, hd = shape
        s0 = torch.randn((B, H, hd, hd), device="cuda")
        for state0 in (None, s0):
            out, state = ops.wkv(r, k, v, w, u, state0)
            want_out, want_state = ref.wkv_ref(r, k, v, w, u, state0)
            torch.testing.assert_close(out, want_out, rtol=TOL, atol=TOL)
            torch.testing.assert_close(state, want_state, rtol=TOL,
                                       atol=TOL)
    # a state0 view that starts 4 bytes past a 16-byte boundary
    r, k, v, w, u = (t.cuda() for t in _t(_inputs(3, 2, 17, 4, 64)))
    s0 = torch.randn(2 * 4 * 64 * 64 + 1, device="cuda")[1:].view(2, 4, 64, 64)
    out, state = ops.wkv(r, k, v, w, u, s0)
    want_out, want_state = ref.wkv_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(out, want_out, rtol=TOL, atol=TOL)
    torch.testing.assert_close(state, want_state, rtol=TOL, atol=TOL)
    # two calls chained through the state equal one call
    r, k, v, w, u = (t.cuda() for t in _t(_inputs(7, 2, 40, 4, 64)))
    full_out, full_state = ops.wkv(r, k, v, w, u)
    _, st1 = ops.wkv(*(t[:, :17].contiguous() for t in (r, k, v, w)), u)
    out2, st2 = ops.wkv(*(t[:, 17:].contiguous() for t in (r, k, v, w)), u,
                        st1)
    torch.testing.assert_close(out2, full_out[:, 17:], rtol=TOL, atol=TOL)
    torch.testing.assert_close(st2, full_state, rtol=TOL, atol=TOL)
    assert kernel.launches["wkv"] > 0
