"""The port's chunk_reduce ops against the JAX kernel (Pallas, interpret
mode) on the same seeded inputs, and the CUDA kernel against its plain
version on the card. JAX is imported by a fixture, so the card test also
runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunk_reduce import kernel, ops, ref  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, the JAX package's chunk_reduce op)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.chunk_reduce.ops import chunk_reduce
    return jnp, chunk_reduce


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("w", [1, 2, 7, 16])
@pytest.mark.parametrize("n", [128, 1000, 4096, 5001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_reduce_matches_jax_kernel(jx, w, n, dtype):
    jnp, jax_chunk_reduce = jx
    jdt, tdt = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    x = np.random.default_rng(1000 * w + n).standard_normal((w, n)) \
        .astype(np.float32)
    want = jax_chunk_reduce(jnp.asarray(x, jdt), block=1024, interpret=True)
    got = ops.chunk_reduce(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (n,)
    # the JAX kernel tests' tolerances (tests/test_kernels.py)
    tol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_chunk_reduce_fp32_accumulation(jx):
    """bf16 inputs accumulate in fp32 (W large, catastrophic in bf16)."""
    jnp, jax_chunk_reduce = jx
    w, n = 16, 512
    x = np.full((w, n), 1.0 + 1e-3, np.float32)
    want = jax_chunk_reduce(jnp.asarray(x, jnp.bfloat16), block=256,
                            interpret=True, out_dtype=jnp.float32)
    got = ops.chunk_reduce(torch.from_numpy(x).to(torch.bfloat16),
                           out_dtype=torch.float32)
    expect = np.float32(w) * np.asarray(jnp.asarray(x[0], jnp.bfloat16),
                                        np.float32)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_reduce_pairs_is_a_plus_b(jx, dtype):
    jnp = jx[0]
    jdt, tdt = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    x = np.random.default_rng(3).standard_normal((12, 1001)) \
        .astype(np.float32)
    buf = torch.tensor(x).to(tdt)          # a copy: x stays the input
    dst, src = [5, 9, 1], [4, 8, 0]
    before = buf.clone()
    ops.chunk_reduce_pairs_(buf, dst, src)
    xj = jnp.asarray(x, jdt)
    for d, s in zip(dst, src):
        want = (xj[d].astype(jnp.float32) + xj[s].astype(jnp.float32)) \
            .astype(jdt)
        np.testing.assert_array_equal(_np(buf[d]),
                                      np.asarray(want, np.float32))
    untouched = [r for r in range(12) if r not in dst]
    assert torch.equal(buf[untouched], before[untouched])


def test_chunk_reduce_pairs_rejects_overlap():
    buf = torch.zeros((6, 8))
    with pytest.raises(ValueError):
        ops.chunk_reduce_pairs_(buf, [1, 2], [2, 3])     # 2 read and written
    with pytest.raises(ValueError):
        ops.chunk_reduce_pairs_(buf, [1, 1], [2, 3])     # 1 written twice


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tdt in (torch.float32, torch.bfloat16):
        # W = 2: the healthy sync after an elastic rescale to 2 members
        for w, n in ((1, 128), (2, 5001), (2, 2 ** 20 + 3), (7, 5001),
                     (16, 2 ** 20 + 3)):
            parts = torch.randn((w, n), generator=gen, device="cuda").to(tdt)
            got = ops.chunk_reduce(parts, out_dtype=torch.float32)
            want = ref.chunk_reduce_ref(parts, torch.float32)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        # the pair form's edges: rows shorter than a vector, lengths that
        # leave a head or tail in every row, one tile +- 1, and views that
        # start 1 or 3 elements past a 16-byte boundary
        tile = kernel.PAIR_TILE_BYTES // torch.empty((), dtype=tdt) \
            .element_size()
        for C in (1, 3, 4, 5, 1000, 4097, 4099, tile - 1, tile, tile + 1):
            for shift in (0, 1, 3):
                store = torch.randn(12 * C + shift, generator=gen,
                                    device="cuda").to(tdt)
                buf = store[shift:].view(12, C)
                for dst, src in (([5, 9, 1], [4, 8, 0]),
                                 ([3, 4, 5], [0, 1, 2])):
                    want = buf.clone()
                    ref.chunk_reduce_pairs_ref_(want, dst, src)
                    ops.chunk_reduce_pairs_(buf, dst, src)
                    assert torch.equal(buf, want), (tdt, C, shift, dst)
    assert kernel.launches["chunk_reduce_pairs"] > 0
