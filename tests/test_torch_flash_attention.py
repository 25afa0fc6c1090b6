"""The port's flash-attention op against the JAX package on the same seeded
inputs: its plain version against the Pallas kernel (interpret mode) over
the JAX kernel tests' sweep, and the query-offset / key-count cases of the
serving path against JAX `direct_attention(q_offset=...)` and
`decode_attention`; the CUDA kernel against the plain version on the card.
JAX is imported by a fixture, so the card test also runs where JAX is not
installed."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the JAX kernel tests' limits (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWEEP = [  # (B, Sq, Skv, H, KV, hd), as test_flash_attention_sweep
    (1, 32, 32, 2, 2, 16),
    (2, 64, 64, 4, 2, 32),     # GQA
    (1, 48, 48, 4, 1, 32),     # MQA
    (2, 40, 40, 2, 2, 8),      # non-multiple of block
]


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, the Pallas kernel, the JAX attention module)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    from repro.models import attention as jattn
    return jnp, flash_attention_pallas, jattn


def _qkv(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _both(jnp, arrays, dtype):
    jdt, tdt = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_flash_kernel(jx, shape, dtype):
    jnp, pallas, _ = jx
    (jq, jk, jv), (q, k, v) = _both(jnp, _qkv(sum(shape), *shape), dtype)
    want = pallas(jq, jk, jv, causal=True, bq=16, bkv=16, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window", [8, 24, 1000])
def test_plain_matches_jax_flash_kernel_window(jx, window):
    jnp, pallas, _ = jx
    (jq, jk, jv), (q, k, v) = _both(jnp, _qkv(window, 2, 64, 64, 4, 2, 16),
                                    "float32")
    want = pallas(jq, jk, jv, causal=True, window=window, bq=16, bkv=16,
                  interpret=True)
    _close(ops.flash_attention(q, k, v, causal=True, window=window), want,
           3e-5)


def test_plain_matches_jax_flash_kernel_noncausal(jx):
    jnp, pallas, _ = jx
    (jq, jk, jv), (q, k, v) = _both(jnp, _qkv(7, 1, 32, 32, 2, 2, 16),
                                    "float32")
    want = pallas(jq, jk, jv, causal=False, bq=16, bkv=16, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=False), want, 3e-5)


# (Sq, Skv, kv_len, q_offset, causal, window): a prompt chunk after a
# cached prefix, a key count short of the buffer, non-causal, and a window
OFFSET_CASES = [
    (8, 40, 40, 32, True, 0),
    (8, 48, 40, 32, True, 0),
    (5, 20, 20, 3, False, 0),
    (8, 28, 28, 20, True, 12),
    (6, 30, 26, 20, True, 4),
]


@pytest.mark.parametrize("case", OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_and_kv_len_match_jax_direct_attention(jx, case, dtype):
    jnp, _, jattn = jx
    Sq, Skv, kv_len, q_offset, causal, window = case
    (jq, jk, jv), (q, k, v) = _both(
        jnp, _qkv(Sq * Skv, 2, Sq, Skv, 4, 2, 16), dtype)
    # JAX has no key count: it gets the first kv_len keys
    want = jattn.direct_attention(jq, jk[:, :kv_len], jv[:, :kv_len],
                                  causal=causal, window=window,
                                  q_offset=q_offset)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("pos", [0, 5, 23])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(jx, pos, dtype):
    jnp, _, jattn = jx
    (jq, jk, jv), (q, k, v) = _both(jnp, _qkv(pos, 2, 1, 24, 4, 2, 16),
                                    dtype)
    want = jattn.decode_attention(jq, jk, jv, jnp.int32(pos))
    got = tattn.decode_attention(q, k, v, pos)
    assert got.shape == q.shape
    _close(got, want, TOL[dtype])


def test_prefill_attention_matches_jax_attention(jx):
    jnp, _, jattn = jx
    (jq, jk, jv), (q, k, v) = _both(jnp, _qkv(3, 2, 24, 24, 4, 2, 16),
                                    "float32")
    _close(tattn.prefill_attention(q, k, v),
           jattn.attention(jq, jk, jv, causal=True), 2e-5)


def _sees_a_key_brute(Sq, kv_len, causal, window, q_offset):
    for i in range(Sq):
        iq = q_offset + i
        if not any((not causal or jk <= iq) and (window <= 0 or
                                                  jk > iq - window)
                   for jk in range(kv_len)):
            return False
    return True


def test_row_precondition_is_exact():
    """check_rows_see_a_key raises exactly when some row sees no key."""
    for Sq, kv_len, q_offset, window, causal in itertools.product(
            range(1, 5), range(1, 7), range(-2, 7), range(0, 5),
            (True, False)):
        ok = _sees_a_key_brute(Sq, kv_len, causal, window, q_offset)
        try:
            ops.check_rows_see_a_key(Sq, kv_len, causal=causal,
                                     window=window, q_offset=q_offset)
            raised = False
        except ValueError:
            raised = True
        assert raised == (not ok), (Sq, kv_len, q_offset, window, causal)


def test_op_refuses_what_it_does_not_run():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 8, 2, 2, 8))
    with pytest.raises(RuntimeError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(ValueError, match="sees no key"):
        ops.flash_attention(q, k, v, causal=True, window=2, q_offset=6,
                            kv_len=5)
    with pytest.raises(ValueError, match="sees no key"):
        ops.flash_attention(q, k, v, causal=True, q_offset=-1)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=9)
    # meta only counts the kernel's work (the dry run); other devices raise
    assert ops.flash_attention(q.to("meta"), k.to("meta"),
                               v.to("meta")).is_meta
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), pytest.raises(ValueError, match="cuda, cpu or "
                                                         "meta"):
        ops.flash_attention(*(torch.empty(t.shape, device="xpu")
                              for t in (q, k, v)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v, causal=True, window=0,
                                    q_offset=0, kv_len=8)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for name, tdt in TORCH_DTYPES.items():
        for B, Sq, Skv, H, KV, hd in SWEEP + [(2, 130, 130, 4, 2, 64),
                                              (1, 70, 70, 2, 1, 128)]:
            q, k, v = (rand(B, Sq, H, hd, dtype=tdt),
                       rand(B, Skv, KV, hd, dtype=tdt),
                       rand(B, Skv, KV, hd, dtype=tdt))
            for causal, window in ((True, 0), (True, 24), (False, 0)):
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
                want = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=TOL[name], atol=TOL[name])
        # decode over one layer of a 5-D cache and over a strided view
        kc = rand(2, 3, 100, 2, 64, dtype=tdt)[1]
        vc = rand(3, 100, 4, 64, dtype=tdt)[:, :, 1:3]
        q = rand(3, 1, 4, 64, dtype=tdt)
        for pos in (0, 1, 57, 99):
            got = tattn.decode_attention(q, kc, vc, pos)
            want = ref.flash_attention_ref(q, kc, vc, q_offset=pos,
                                           kv_len=pos + 1)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[name], atol=TOL[name])
    assert kernel.launches["flash_attention"] > 0
