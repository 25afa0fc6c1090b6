"""The flash-attention op's three CUDA routes: the rule that picks one
(`kernel.route`, decided on the host from dtype, head dim, rows per kv head
and alignment), the decode kernel's split count, and its split-and-combine
arithmetic in plain PyTorch (`ref.flash_attention_split_ref`) against JAX
`direct_attention(q_offset=...)`; on the card, `flash_prefill` and
`flash_decode` against the plain version. JAX is imported by a fixture, so
the card tests also run where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
ALIGNED = [0, 4096, 256, 2048, 128]


@pytest.fixture(scope="module")
def jattn():
    pytest.importorskip("jax")
    from repro.models import attention
    return attention


@pytest.mark.parametrize("dtype,hd,rows,steps,want", [
    (BF, 128, 2, ALIGNED, "flash_decode"),       # qwen3 decode step
    (F32, 128, 2, ALIGNED, "flash_decode"),      # decode takes any dtype
    (F32, 8, 16, ALIGNED, "flash_decode"),       # ... and head dim
    (BF, 16, 1, ALIGNED, "flash_decode"),
    (BF, 128, 17, ALIGNED, "flash_prefill"),     # past 16 rows: a prompt
    (BF, 128, 4096, ALIGNED, "flash_prefill"),   # qwen3 prefill
    (BF, 64, 4096, ALIGNED, "flash_prefill"),
    (BF, 32, 4096, ALIGNED, "flash_attention"),  # no prefill template
    (F32, 128, 4096, ALIGNED, "flash_attention"),  # fp32 prompt
    (F32, 16, 24, ALIGNED, "flash_attention"),   # the fp32 smoke prefill
    (BF, 128, 4096, ALIGNED + [8], "flash_attention"),   # stride of 8 bytes
    (BF, 128, 2, ALIGNED + [24], "flash_attention"),     # ... also for decode
    (BF, 128, 2, [2] + ALIGNED, "flash_attention"),      # unaligned address
])
def test_route_rule(dtype, hd, rows, steps, want):
    assert kernel.route(dtype, hd, rows, steps) == want


def test_model_tensors_take_the_new_routes():
    """At qwen3-1.7b's serve shapes the prefill's q, k, v and a decode
    step's q with one layer's slice of the 5-D cache take the new kernels;
    the fp32 smoke config's prompt takes the CUDA-core kernel."""
    cfg = get_config("qwen3-1.7b")
    B, S, H, KV, hd = 1, 256, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.zeros(B, S, H * hd, dtype=BF).reshape(B, S, H, hd)
    k = torch.zeros(B, S, KV, hd, dtype=BF)
    assert kernel.pick_route(q, k, k) == "flash_prefill"
    cache = transformer.init_cache(cfg.replace(n_layers=3), B, S + 4, "cpu")
    assert kernel.pick_route(q[:, :1], cache["k_glob"][2],
                             cache["v_glob"][2]) == "flash_decode"
    smoke = get_config("qwen3-1.7b", smoke=True)
    qs = torch.zeros(2, 12, smoke.n_heads, smoke.hd)
    ks = torch.zeros(2, 12, smoke.n_kv_heads, smoke.hd)
    assert kernel.pick_route(qs, ks, ks) == "flash_attention"
    assert kernel.pick_route(qs[:, :1], ks, ks) == "flash_decode"


def test_route_misaligned_view():
    """A k that starts 4 elements into its storage is not 16-byte aligned:
    the CUDA-core kernel takes it."""
    q = torch.zeros(1, 1, 2, 64, dtype=BF)
    k = torch.zeros(1, 9, 2, 64, dtype=BF).reshape(-1)[4:4 + 8 * 128] \
        .reshape(1, 8, 2, 64)
    assert kernel.pick_route(q, k, k) == "flash_attention"


@pytest.mark.parametrize("kv_len,want", [
    (1, 1), (63, 1), (64, 1), (65, 2), (128, 2), (129, 3), (2081, 5),
    (2111, 5)])
def test_decode_split_count_at_qwen3(kv_len, want):
    """qwen3-1.7b's decode: B 8 x KV 8 = 64 groups on 132 SMs want 5 CTAs
    a group (~2 a SM), each over at least 64 keys."""
    assert kernel.decode_splits(kv_len, 64, 132) == want


def test_decode_split_count_properties():
    for groups in (1, 8, 64, 512):
        prev = 0
        for n in range(1, 2112):
            ns = kernel.decode_splits(n, groups, 132)
            assert 1 <= ns <= kernel.DECODE_MAX_SPLITS
            assert ns >= prev                       # more keys, no fewer CTAs
            assert ns == 1 or -(-n // ns) >= kernel.DECODE_MIN_KEYS // 2
            # every split starts inside the keys
            assert (ns - 1) * -(-n // ns) < n
            # enough CTAs for the card, unless the keys or the cap run out
            assert ns * groups >= kernel.DECODE_CTAS_PER_SM * 132 \
                or ns in (-(-n // kernel.DECODE_MIN_KEYS),
                          kernel.DECODE_MAX_SPLITS)
            prev = ns


def test_seen_keys():
    assert kernel.seen_keys(1, 5, causal=True, window=0, q_offset=4) == (0, 5)
    assert kernel.seen_keys(8, 40, causal=True, window=3,
                            q_offset=30) == (28, 38)
    assert kernel.seen_keys(4, 40, causal=False, window=0,
                            q_offset=3) == (0, 40)


def _qkv(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


# (Sq, H, KV, Skv, kv_len, q_offset, causal, window): one-token decode steps
# at the first and a later position, GQA rep 1 / 2 / 4, a window, and 16
# rows of 8 queries whose narrow windows leave most splits without a key
DECODE_CASES = [
    (1, 4, 2, 40, 1, 0, True, 0),
    (1, 4, 2, 40, 37, 36, True, 0),
    (1, 4, 4, 40, 40, 39, True, 0),
    (1, 8, 2, 40, 33, 32, True, 0),
    (1, 4, 2, 40, 30, 29, True, 7),
    (8, 4, 2, 40, 38, 30, True, 3),
    (2, 4, 2, 40, 40, 38, False, 0),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_ref_matches_jax_direct_attention(jattn, case, n_split):
    import jax.numpy as jnp
    Sq, H, KV, Skv, kv_len, q_offset, causal, window = case
    q, k, v = _qkv(kv_len + n_split, 2, Sq, Skv, H, KV, 16)
    want = jattn.direct_attention(
        jnp.asarray(q), jnp.asarray(k[:, :kv_len]), jnp.asarray(v[:, :kv_len]),
        causal=causal, window=window, q_offset=q_offset)
    got = ref.flash_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), n_split, causal=causal,
        window=window, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_split_ref_equals_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 64, 4, 2, 32))
    for n_split in (1, 2, 5, 16):
        for kw in ({"q_offset": 50, "kv_len": 58},
                   {"q_offset": 50, "kv_len": 58, "window": 2},
                   {"causal": False, "kv_len": 64}):
            torch.testing.assert_close(
                ref.flash_attention_split_ref(q, k, v, n_split, **kw),
                ref.flash_attention_ref(q, k, v, **kw), rtol=1e-6,
                atol=1e-6)


def _ulp_bf16(x):
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _check_route(q, k, v, route, **kw):
    """The op on the card takes `route` and agrees with the plain version
    within 2e-5 (1 + |plain|), plus one bf16 ulp of |plain| in bf16."""
    before = dict(kernel.launches)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert [n for n in kernel.launches
            if kernel.launches[n] != before[n]] == [route]
    limit = 2e-5 * (1 + want.float().abs())
    if q.dtype == BF:
        limit = limit + _ulp_bf16(want)
    assert bool(((got.float() - want.float()).abs() <= limit).all()), kw


@pytest.mark.cuda
def test_cuda_prefill_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(BF)

    for hd in kernel.PREFILL_HEAD_DIMS:
        for rep in (1, 2, 4):
            q, k, v = rand(2, 150, 2 * rep, hd), rand(2, 150, 2, hd), \
                rand(2, 150, 2, hd)
            for kw in ({}, {"window": 24}, {"causal": False}):
                _check_route(q, k, v, "flash_prefill", **kw)
            k, v = rand(2, 300, 2, hd), rand(2, 300, 2, hd)
            _check_route(q, k, v, "flash_prefill", q_offset=140, kv_len=290)


@pytest.mark.cuda
def test_cuda_decode_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (BF, F32):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for hd in kernel.HEAD_DIMS:
            # one layer of a 5-D cache, read in place
            kc, vc = rand(2, 3, 700, 2, hd)[1], rand(2, 3, 700, 2, hd)[0]
            for rep in (1, 2, 8):
                q = rand(3, 1, 2 * rep, hd)
                for kv_len in (1, 64, 65, 700):
                    _check_route(q, kc, vc, "flash_decode",
                                 q_offset=kv_len - 1, kv_len=kv_len)
            q = rand(3, 8, 4, hd)
            _check_route(q, kc, vc, "flash_decode", q_offset=600,
                         kv_len=608, window=5)
