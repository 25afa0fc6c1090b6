"""The general flash-attention route (csrc/flash_attention.cu, tensor-core
3xTF32) on the CPU: a plain torch emulation of the kernel's arithmetic
(TF32 rounding to nearest, ties away, on the fp32 bits; hi + lo splits and
the product counts of the source's `Splits<T>`; key tiles of
`kernel.GENERAL_BKV`; the online softmax in base 2; p v with the keys of
each 8-key step in the kernel's permuted order, each tile's p v summed
apart and added to the accumulator) held against the plain
version and the JAX Pallas kernel (interpret mode); one TF32 product a
plain product, which the 2e-5 limit must catch; the split's residual; and
the Python mirror of the launch plan (`kernel.general_plan`,
`kernel.general_slot`) against the C source's constants, the shared-memory
limit and the grid's cover of every row slot; the bound chip_smoke.py
holds the route to. On the card, the kernel against the plain version."""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import SMEM_PER_CTA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
DTYPES = {"float32": F32, "bfloat16": BF}
LIMIT = 2e-5                # chip_smoke.py's limit for the fp32 route
LOG2E = 1.4426950408889634
SOURCE = (pathlib.Path(kernel.__file__).parent / "csrc"
          / "flash_attention.cu")
REPO = pathlib.Path(__file__).resolve().parent.parent
# TF32 products per plain product (q k^T, p v), the source's Splits<T>:
# fp32 operands are split into hi + lo and take 3; bf16 ones are exact in
# TF32, so q k^T takes 1 and p v 2 (p's hi and lo against v)
SPLITS = {F32: (3, 3), BF: (1, 2)}
# the kernel's key order within an 8-key step of p v: A's column c is key
# 2c for c < 4 and 2 (c - 4) + 1 after
PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero: add half of the dropped 13 bits' range to the bits
    and clear them (cvt.rna.tf32.f32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def products(a, b, n: int, small_first: bool = True):
    """The (A, B) operand pairs of n TF32 products of a b, in the kernel's
    order: 1 hi hi; 2 a_lo b_hi + hi hi (b exact in TF32); 3 a_lo b_hi +
    a_hi b_lo + hi hi."""
    ah, al = split(a)
    bh, bl = split(b) if n >= 3 else (tf32(b), None)
    small = [(al, bh)] * (n >= 2) + [(ah, bl)] * (n >= 3)
    return small + [(ah, bh)] if small_first else [(ah, bh)] + small


def emulate(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None,
            splits=None, small_first=True) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, fp32 out (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    n_qk, n_pv = splits or SPLITS[q.dtype]
    rep = H // k.shape[2]
    qq = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, hd)
    kk = k.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    vv = v.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    scale_log2 = float(np.float32(1.0 / float(np.sqrt(hd)) * LOG2E))
    iq = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    lsum = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    bkv = kernel.GENERAL_BKV
    for kb in range(0, kv_len, bkv):
        kt = torch.zeros((B, H, bkv, hd))
        vt = torch.zeros((B, H, bkv, hd))
        n = min(bkv, kv_len - kb)
        kt[:, :, :n], vt[:, :, :n] = kk[:, :, kb:kb + n], vv[:, :, kb:kb + n]
        s = torch.zeros((B, H, Sq, bkv))
        for d in range(0, hd, 8):
            for a, b in products(qq[..., d:d + 8], kt[..., d:d + 8], n_qk,
                                 small_first):
                s = s + a @ b.transpose(-1, -2)
        jk = kb + torch.arange(bkv)[None, :]
        ok = jk < kv_len
        if causal:
            ok = ok & (jk <= iq)
        if window > 0:
            ok = ok & (jk > iq - window)
        x = torch.where(ok, s * scale_log2, torch.tensor(-1e30))
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        m_use = torch.where(mx == -1e30, torch.tensor(0.0), mx)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        m = mx
        # the tile's p v in a fresh sum, added to acc in fp32
        f = torch.zeros_like(acc)
        for j in range(0, bkv, 8):
            idx = [j + c for c in PERM]
            for a, b in products(p[..., idx], vt[:, :, idx], n_pv,
                                 small_first):
                f = f + a @ b
        acc = acc + f
    out = acc * (1.0 / lsum.clamp(min=1e-30))
    return out.permute(0, 2, 1, 3)


def _qkv(seed, B, Sq, Skv, H, KV, hd, dtype=F32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((B, Sq, H, hd), (B, Skv, KV, hd),
                                 (B, Skv, KV, hd))]


def _within(got, want, ulp=False):
    """max |got - want| and whether it is within LIMIT (1 + |want|) (plus
    one bf16 ulp of |want|)."""
    got, want = got.float(), want.float()
    limit = LIMIT * (1 + want.abs())
    if ulp:
        _, e = torch.frexp(want.abs().clamp(min=2.0 ** -126))
        limit = limit + torch.ldexp(torch.ones_like(want), e - 8)
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= limit).all())


# (B, Sq, Skv, H, KV, hd, kwargs): the JAX kernel tests' sweep, hd 64 / 128
# at GQA rep 1 / 2 / 4 with a ragged Sq, windows, non-causal, and a chunk
# of queries after a cached prefix with a key count short of the buffer
CASES = [
    (1, 32, 32, 2, 2, 16, {}),
    (2, 64, 64, 4, 2, 32, {}),
    (1, 48, 48, 4, 1, 32, {}),
    (2, 40, 40, 2, 2, 8, {}),
    (1, 40, 40, 2, 2, 64, {}),
    (1, 37, 37, 4, 2, 128, {}),
    (1, 24, 24, 8, 2, 64, {}),
    (2, 64, 64, 4, 2, 16, {"window": 8}),
    (2, 64, 64, 4, 2, 16, {"window": 24}),
    (2, 64, 64, 4, 2, 16, {"window": 1000}),
    (1, 33, 33, 2, 1, 64, {"causal": False}),
    (1, 13, 90, 4, 2, 64, {"q_offset": 70, "kv_len": 83}),
    (1, 9, 70, 2, 2, 128, {"q_offset": 50, "kv_len": 59, "window": 5}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulation_matches_plain_version(case, dtype):
    *shape, kw = CASES[case]
    q, k, v = _qkv(case, *shape, DTYPES[dtype])
    got = emulate(q, k, v, **kw)
    # the kernel works in fp32 from the inputs as given (bf16 is exact in
    # fp32): hold it to the fp32 plain version at the fp32 limit
    err, ok = _within(got, ref.flash_attention_ref(q.float(), k.float(),
                                                   v.float(), **kw))
    assert ok, err
    if dtype == "bfloat16":     # and after the output's rounding
        err, ok = _within(got.to(BF), ref.flash_attention_ref(q, k, v, **kw),
                          ulp=True)
        assert ok, err


@pytest.fixture(scope="module")
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    return jnp, flash_attention_pallas


@pytest.mark.parametrize("shape,kw,tol", [
    ((1, 32, 32, 2, 2, 16), {}, 2e-5),
    ((2, 64, 64, 4, 2, 32), {}, 2e-5),
    ((2, 40, 40, 2, 2, 8), {}, 2e-5),
    ((2, 64, 64, 4, 2, 16), {"window": 24}, 3e-5),
    ((1, 32, 32, 2, 2, 16), {"causal": False}, 3e-5),
])
def test_emulation_matches_jax_flash_kernel(pallas, shape, kw, tol):
    jnp, fn = pallas
    q, k, v = _qkv(sum(shape), *shape)
    want = fn(*(jnp.asarray(t.numpy()) for t in (q, k, v)), bq=16, bkv=16,
              interpret=True, **kw)
    np.testing.assert_allclose(emulate(q, k, v, **kw).numpy(),
                               np.asarray(want), rtol=tol, atol=tol)


def test_one_tf32_product_misses_the_limit():
    """With one TF32 product each (no lo terms) the error at hd 128, S 256
    is past 2e-5 (1 + |plain|): the chip's limit tells a kernel that drops
    the correction terms from one that keeps them."""
    q, k, v = _qkv(11, 1, 256, 256, 2, 2, 128)
    want = ref.flash_attention_ref(q, k, v)
    err3, ok3 = _within(emulate(q, k, v), want)
    err1, ok1 = _within(emulate(q, k, v, splits=(1, 1)), want)
    assert ok3 and not ok1, (err3, err1)
    assert err1 > 10 * err3


def test_product_order_changes_little():
    """Small terms first (the kernel) or hi hi first: both within the
    limit, and within 2x of each other."""
    q, k, v = _qkv(12, 1, 64, 64, 2, 1, 128)
    want = ref.flash_attention_ref(q, k, v)
    errs = [_within(emulate(q, k, v, small_first=f), want) for f in
            (True, False)]
    assert all(ok for _, ok in errs)
    assert max(e for e, _ in errs) <= 2 * min(e for e, _ in errs) + 1e-7


@pytest.mark.parametrize("scale_exp", [-60, -10, 0, 10, 60])
def test_split_residual_and_tf32_bits(scale_exp):
    rng = np.random.default_rng(scale_exp + 100)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 2.0 ** scale_exp).astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):          # only the TF32 bits are set
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -21 * x.double().abs()).all())
    # hi is the nearest TF32 value
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())


def test_tf32_rounds_ties_away():
    one_ulp = 2.0 ** -10     # TF32's step at 1.0
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + 3 * one_ulp / 2, 1 + one_ulp / 2 - 2.0 ** -23,
                      0.0, float("inf")])
    assert tf32(x).tolist() == [1 + one_ulp, -(1 + one_ulp),
                                1 + 2 * one_ulp, 1.0, 0.0, float("inf")]


def _constant(name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = (\w+);", SOURCE.read_text())
    assert m, name
    return m.group(1)


def test_plan_mirrors_the_source():
    assert int(_constant("kWarps")) == kernel.GENERAL_WARPS
    assert int(_constant("kBKV")) == kernel.GENERAL_BKV
    assert int(_constant("kStages")) == kernel.GENERAL_STAGES
    text = SOURCE.read_text()
    for ctype, dtype in (("float", F32), ("__nv_bfloat16", BF)):
        m = re.search(rf"struct Splits<{ctype}> {{ static constexpr int "
                      rf"qk = (\d), pv = (\d); }}", text)
        assert m and tuple(map(int, m.groups())) == SPLITS[dtype]
    # the sums the emulation models: p v per key tile apart, added to acc;
    # q k^T in the MMA accumulator
    assert "acc[d0 + i][e] += f[i][e];" in text
    assert "mma_products<QK, NT>(s, ah, al, bh, bl);" in text
    assert "HD * static_cast<int>(sizeof(T)) + 16" in text   # row bytes


ROWS = [1, 2, 15, 16, 17, 24, 63, 64, 65, 200, 4096]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_general_plan_fits_and_covers_every_slot(hd, itemsize, aligned):
    for rows in ROWS:
        plan = kernel.general_plan(hd, itemsize, rows, aligned)
        assert plan["smem"] <= SMEM_PER_CTA
        assert plan["row_bytes"] % 16 == 0          # 16-byte cp.async rows
        # the B-fragment reads: K at (row gq, col tq), V at (row 2 tq,
        # col gq); fp32 rows of hd + 4 words put each warp's 32 reads in
        # 32 banks
        if itemsize == 4:
            words = plan["row_bytes"] // 4
            for rows_of, cols_of in ((lambda g, t: g, lambda g, t: t),
                                     (lambda g, t: 2 * t, lambda g, t: g)):
                banks = {(rows_of(g, t) * words + cols_of(g, t)) % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32
        if rows <= kernel.DECODE_MAX_ROWS:
            assert plan["warps"] == 1 and plan["staging"] != "cp.async 16"
        else:
            assert plan["warps"] == kernel.GENERAL_WARPS
            assert (plan["staging"] == "cp.async 16") == aligned
        bx, w, r = np.meshgrid(np.arange(plan["grid_x"]),
                               np.arange(plan["warps"]), np.arange(16),
                               indexing="ij")
        slots = kernel.general_slot(plan, bx, w, r).ravel()
        live = slots[slots < rows]
        assert np.array_equal(np.sort(live), np.arange(rows))
        assert len(slots) - len(live) < plan["rows"]   # one ragged CTA


def test_general_plan_at_qwen3_prefill():
    """qwen3-1.7b's fp32 prefill (16 / 8 heads, hd 128, S 2048): 4096 slots
    per (b, kv head) in 64 CTAs of 4 warps; 101,376 bytes of ring, so two
    CTAs (8 warps) fit an SM's 228 KB; the last row block runs first."""
    plan = kernel.general_plan(128, 4, 2048 * 2, True)
    assert plan["grid_x"] == 64 and plan["warps"] == 4
    assert plan["smem"] == 3 * 2 * 32 * (128 * 4 + 16) == 101376
    assert 2 * (plan["smem"] + 1024) <= 233472
    assert kernel.general_slot(plan, 0, 0, 0) == 4096 - 64


def test_bound_counts_the_kernels_products():
    """chip_smoke's bound for fp32 attention: the plain flops at a third of
    the TF32 rate (3 TF32 products a plain product, as this kernel runs in
    fp32), faster than fp32 FMAs; bf16 inputs at the bf16 rate."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sum(SPLITS[F32]) / 2 == 3
    assert smoke.ATTN_FP32_FLOPS == smoke.TF32_FLOPS / 3 > smoke.FP32_FLOPS
    b = smoke._bound(0, 3 * 10 ** 12, smoke.ATTN_FP32_FLOPS)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(3 * 3 / 495 * 1e3)
    assert smoke.BF16_FLOPS == 989e12


@pytest.mark.cuda
def test_cuda_general_kernel_matches_plain_version():
    """On the card: fp32 at hd 64 / 128, rep 1 / 2 / 4, a ragged Sq,
    windows, non-causal, a chunk after a cached prefix; views off 16-byte
    alignment in both dtypes at a prompt and at <= 16 rows; bf16 at hd 8 /
    16 / 32. Each call takes the general route and is within 2e-5
    (1 + |plain|) (plus one bf16 ulp in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype=F32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(q, k, v, **kw):
        before = kernel.launches["flash_attention"]
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kernel.launches["flash_attention"] == before + 1, kw
        err, ok = _within(got, want, ulp=q.dtype == BF)
        assert ok, (tuple(q.shape), q.dtype, kw, err)

    for hd in (64, 128):
        for rep in (1, 2, 4):
            q, k, v = rand(2, 150, 2 * rep, hd), rand(2, 150, 2, hd), \
                rand(2, 150, 2, hd)
            for kw in ({}, {"window": 8}, {"window": 24}, {"window": 1000},
                       {"causal": False}):
                check(q, k, v, **kw)
            k, v = rand(2, 300, 2, hd), rand(2, 300, 2, hd)
            check(q, k, v, q_offset=140, kv_len=290)
    for dtype in (F32, BF):
        for hd in kernel.HEAD_DIMS:
            store = rand(2 * 300 * 2 * hd + 3, dtype=dtype)
            k = store[1:1 + 2 * 300 * 2 * hd].view(2, 300, 2, hd)
            v = store[3:3 + 2 * 300 * 2 * hd].view(2, 300, 2, hd)
            check(rand(2, 150, 4, hd, dtype=dtype), k, v)
            check(rand(2, 1, 4, hd, dtype=dtype), k, v, q_offset=290,
                  kv_len=291)
            check(rand(2, 8, 4, hd, dtype=dtype), k, v, q_offset=280,
                  kv_len=288, window=5)
    for hd in (8, 16, 32):
        for rep in (1, 2, 4):
            q = rand(2, 100, 2 * rep, hd, dtype=BF)
            k, v = rand(2, 100, 2, hd, dtype=BF), rand(2, 100, 2, hd, dtype=BF)
            check(q, k, v)
            check(q, k, v, window=24)
