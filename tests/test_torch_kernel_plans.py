"""The launch plans and schedules of the port's redesigned kernels, on the
CPU: the chunk_reduce pair form's tile schedule (every element of every
pair once; aligned bulk bodies; int64 offsets at the training path's
shape) and a plain torch emulation of it against `chunk_reduce_pairs_ref_`;
the wkv launch plan (every (b, h, column, part) once; thread and
shared-memory limits) and a plain torch emulation of the kernel's
four-part column split against `wkv_ref` (bit for bit) and the JAX Pallas
kernel (interpret mode, the JAX wkv tests' 1e-5); the general flash route's
plan at head dim 12 (its MMA width padded to 16)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunk_reduce import kernel as ck  # noqa: E402
from repro_torch.kernels.chunk_reduce import ref as cref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.wkv import kernel as wk  # noqa: E402
from repro_torch.kernels.wkv import ref as wref  # noqa: E402

SMS = 132                          # H100 SXM
DTYPES = {4: torch.float32, 2: torch.bfloat16}
PAIRS = ([5, 9, 1], [4, 8, 0])     # one reduce-scatter hop at p=4 (3 chunks)
ROWS = 12
BASE = 1 << 40                     # a 512-byte aligned allocation


def _edge_lengths(itemsize):
    te = ck.PAIR_TILE_BYTES // itemsize
    return [1, 3, 4, 5, 1000, 4097, te - 1, te, te + 1]


def _pieces(C, itemsize, shift):
    """Every tile of the pair form over PAIRS in a buffer that starts
    `shift` elements past BASE: (pair, dst elem, src elem, head, body,
    tail)."""
    dst, src = PAIRS
    te = ck.PAIR_TILE_BYTES // itemsize
    for t in range(ck.pairs_tiles(len(dst), C, itemsize)):
        j, off, n = ck.pairs_tile(t, C, te)
        d0, s0 = shift + dst[j] * C + off, shift + src[j] * C + off
        head, body, tail = ck.tile_split(BASE + d0 * itemsize,
                                         BASE + s0 * itemsize, n, itemsize)
        assert head + body + tail == n
        yield j, d0, s0, head, body, tail


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("case", range(9))
def test_pair_schedule_covers_every_element_once(case, itemsize, shift):
    C = _edge_lengths(itemsize)[case]
    seen = np.zeros((len(PAIRS[0]), C), np.int64)
    dst = PAIRS[0]
    for j, d0, s0, head, body, tail in _pieces(C, itemsize, shift):
        if body:
            for e in (d0, s0):
                assert (BASE + (e + head) * itemsize) % 16 == 0
            assert body * itemsize % 16 == 0
        off = d0 - shift - dst[j] * C
        seen[j, off:off + head + body + tail] += 1
    assert (seen == 1).all()


def test_pair_schedule_at_the_training_shape():
    """3 pairs of C = 573,524,992 fp32 (one degraded reduce-scatter hop of
    qwen3-1.7b's padded gradient at p=4; no allocation): one CTA per tile
    fits the grid, the tiles of each pair run contiguously over its row,
    all of them whole vectors (C % 4 == 0), with element offsets past
    2^31."""
    C, itemsize = 573_524_992, 4
    te = ck.PAIR_TILE_BYTES // itemsize
    assert ck.pairs_tiles(3, C, itemsize) == 3 * -(-C // te) < 2 ** 31
    end = [0, 0, 0]
    widest = 0
    for j, d0, s0, head, body, tail in _pieces(C, itemsize, 0):
        assert head == 0 and tail == 0
        assert d0 - PAIRS[0][j] * C == end[j]
        end[j] += body
        widest = max(widest, d0 + body, s0 + body)
    assert end == [C] * 3
    assert widest > 2 ** 31 and (widest - 1) * itemsize > 2 ** 32


def _emulate_pairs(buf, dst, src, shift):
    """The kernel's schedule in plain torch: each tile's head, vector body
    and tail added on their own, fp32 add and one rounding, as the kernel
    does; buf is a view `shift` elements into its storage."""
    out = buf.clone()
    flat = out.view(-1)
    C, isz = buf.shape[1], buf.element_size()
    for t in range(ck.pairs_tiles(len(dst), C, isz)):
        j, off, n = ck.pairs_tile(t, C, ck.PAIR_TILE_BYTES // isz)
        d0, s0 = dst[j] * C + off, src[j] * C + off
        head, body, _ = ck.tile_split(BASE + (shift + d0) * isz,
                                      BASE + (shift + s0) * isz, n, isz)
        for a, b in ((0, head), (head, head + body), (head + body, n)):
            flat[d0 + a:d0 + b] = (flat[d0 + a:d0 + b].float()
                                   + flat[s0 + a:s0 + b].float()
                                   ).to(buf.dtype)
    return out


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("case", [0, 3, 5, 7, 8])
def test_pair_schedule_emulation_equals_plain_version(case, itemsize, shift):
    C = _edge_lengths(itemsize)[case]
    rng = np.random.default_rng(C + shift)
    store = torch.from_numpy(rng.standard_normal(ROWS * C + shift)
                             .astype(np.float32)).to(DTYPES[itemsize])
    buf = store[shift:].view(ROWS, C)
    want = buf.clone()
    cref.chunk_reduce_pairs_ref_(want, *PAIRS)
    assert torch.equal(_emulate_pairs(buf, *PAIRS, shift), want)


@pytest.mark.parametrize("n_pairs,C,itemsize", [
    (1, 1, 4), (3, 4097, 2), (6, 10 ** 6, 4), (3, 573_524_992, 4),
    (3, 2 ** 31, 2), (2 ** 16, 2 ** 20, 4)])
def test_pair_tile_count(n_pairs, C, itemsize):
    """The tile count is the sum of each row's tiles and the last tile of
    a row ends at its end, at small and grid-sized shapes."""
    te = ck.PAIR_TILE_BYTES // itemsize
    tiles = ck.pairs_tiles(n_pairs, C, itemsize)
    per_pair = tiles // n_pairs
    assert tiles == n_pairs * per_pair
    j, off, n = ck.pairs_tile(per_pair - 1, C, te)
    assert j == 0 and off + n == C and 1 <= n <= te
    assert ck.pairs_tile(per_pair, C, te)[:2] == (1, 0)   # the next row


# ---------------------------------------------------------------------------
# wkv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 15, 16, 17, 33, 1024])
@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_wkv_plan_covers_every_column_part_once(hd, S):
    for B, H in ((4, 64), (1, 2), (2, 3), (8, 32)):
        plan = wk.wkv_plan(B, S, H, hd, SMS)
        threads = plan["threads"]
        assert threads % 32 == 0 and threads <= 1024
        assert plan["smem"] <= wk.SMEM_PER_CTA
        assert 1 <= plan["chunk"] <= S
        gx, gy, gz = plan["grid"]
        bx, by, bz, tid = np.meshgrid(np.arange(gx), np.arange(gy),
                                      np.arange(gz), np.arange(threads),
                                      indexing="ij")
        owned = [wk.wkv_thread_owner(plan, bx, by, bz, tid, c)
                 for c in range(plan["jc"])]
        b, h, j, p = (np.concatenate([o[i].ravel() for o in owned])
                      for i in range(4))
        assert (b < B).all() and (h < H).all() and (j < hd).all()
        key = ((b * H + h) * hd + j) * 4 + p
        assert np.array_equal(np.bincount(key, minlength=B * H * hd * 4),
                              np.ones(B * H * hd * 4, np.int64))


def test_wkv_plan_at_rwkv6_shapes():
    """rwkv6-7b (64 heads of 64), batch 4: the prompt takes whole heads
    (256 CTAs of 64 columns, 2 a thread), a decode step 4 column blocks of
    16 per head (1024 CTAs, 1 column a thread)."""
    for S, chunk, cols, jc in ((1024, wk.WKV_CHUNK, 64, 2), (1, 1, 16, 1)):
        plan = wk.wkv_plan(4, S, 64, 64, SMS)
        assert plan["grid"] == (64 // cols, 64, 4) and plan["jc"] == jc
        assert plan["threads"] == 4 * cols // jc and plan["chunk"] == chunk
        assert plan["smem"] == wk.wkv_smem(64, cols, chunk)
        assert 2 * (plan["smem"] + 1024) <= 233472   # 2 CTAs an SM (228 KB)


def _wkv_parts(r, k, v, w, u, state0=None):
    """The kernel's arithmetic in plain torch: part p of every column keeps
    rows p, p + 4, ... of the state and its partial sum over them in
    increasing row order; the parts combine as (o0 + o1) + (o2 + o3)."""
    B, S, H, hd = r.shape
    state = (torch.zeros((B, H, hd, hd)) if state0 is None
             else state0.clone())
    outs = []
    for t in range(S):
        parts = []
        for p in range(4):
            o = None
            for kk in range(p, hd, 4):
                kv = k[:, t, :, kk, None] * v[:, t]              # (B, H, hd)
                term = r[:, t, :, kk, None] * (
                    state[:, :, kk] + u[None, :, kk, None] * kv)
                o = term if o is None else o + term
                state[:, :, kk] = w[:, t, :, kk, None] * state[:, :, kk] + kv
            parts.append(o)
        outs.append((parts[0] + parts[1]) + (parts[2] + parts[3]))
    return torch.stack(outs, 1), state


def _wkv_inputs(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (B, S, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return (r, k, v, w, u), s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_wkv_part_emulation_equals_plain_version(hd, with_state):
    arrays, s0 = _wkv_inputs(hd, 2, 17, 2, hd)
    x = [torch.from_numpy(a) for a in arrays]
    state0 = torch.from_numpy(s0) if with_state else None
    out, state = _wkv_parts(*x, state0)
    want_out, want_state = wref.wkv_ref(*x, state0)
    assert torch.equal(out, want_out) and torch.equal(state, want_state)


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, the Pallas wkv kernel)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.wkv.kernel import wkv_pallas
    return jnp, wkv_pallas


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("hd", [8, 32])
def test_wkv_part_emulation_matches_jax_kernel(jx, hd, with_state):
    jnp, pallas = jx
    arrays, s0 = _wkv_inputs(100 + hd, 1, 16, 2, hd)
    kw = {"state0": jnp.asarray(s0)} if with_state else {}
    want_out, want_state = pallas(*map(jnp.asarray, arrays), interpret=True,
                                  **kw)
    out, state = _wkv_parts(*(torch.from_numpy(a) for a in arrays),
                            torch.from_numpy(s0) if with_state else None)
    for got, want in ((out, want_out), (state, want_state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "unaligned"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [1, 6, 16, 17, 24, 4096],
                         ids=lambda r: f"rows{r}")
def test_general_plan_at_hd12(rows, itemsize, aligned):
    """Head dim 12: rows of the MMA's 16 columns (4 of them zeros) plus 16
    bytes of padding; a decode step (<= 16 rows) one warp with 4-byte or
    plain staging; a prompt 4 warps, staged by 16-byte cp.async only for
    aligned fp32 (a 48-byte row is 3 copies; a 24-byte bf16 row is not a
    whole number of them)."""
    plan = fk.general_plan(12, itemsize, rows, aligned)
    assert plan["mma_hd"] == 16
    assert plan["row_bytes"] == 16 * itemsize + 16
    assert plan["smem"] == 3 * 2 * 32 * plan["row_bytes"]
    assert plan["grid_x"] == -(-rows // plan["rows"])
    if rows <= fk.DECODE_MAX_ROWS:
        assert plan["warps"] == 1 and plan["rows"] == 16
        assert plan["staging"] == ("cp.async 4" if itemsize == 4
                                   else "load")
        return
    assert plan["warps"] == fk.GENERAL_WARPS
    want = ("cp.async 16" if aligned and itemsize == 4 else
            "cp.async 4" if itemsize == 4 else "load")
    assert plan["staging"] == want
    if want == "cp.async 16":
        # 3 copies a row, every destination on a 16-byte boundary of the
        # ring, none reaching the zero columns 12-15
        starts = [(r * plan["row_bytes"] + 16 * c) for r in range(64)
                  for c in range(3)]
        assert all(b % 16 == 0 for b in starts)
        assert 3 * 16 == 12 * itemsize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 6, 16, 24, 4096],
                         ids=lambda r: f"rows{r}")
def test_route_at_hd12_is_general(rows, dtype):
    """Every hd-12 call, aligned or not, prompt or decode step, takes the
    general route: flash_decode and flash_prefill have no hd-12 template."""
    dt = getattr(torch, dtype)
    for steps in ([0, 4096, 256, 2048, 128], [4, 4096, 256, 2048, 128]):
        assert fk.route(dt, 12, rows, steps) == "flash_attention"
