// flash_prefill: the tensor-core flash-attention forward for Hopper (sm_90a),
// bf16 in and out, head dim 64 or 128: softmax(q k^T * scale + mask) v.
//
// Replaces, for bf16 prompts (more than 16 rows per kv head), the Pallas TPU
// kernel src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel): an online softmax over KV blocks with fp32 running
// max m, sum l and accumulator acc, finished as acc / max(l, 1e-30). The
// masks, the query offset and the key count are those of flash_attention.cu:
// key jk is seen by the query at iq = q_offset + i when
//   jk < kv_len  and (not causal or jk <= iq)  and (window <= 0 or jk > iq - window).
// The caller guarantees that every row sees at least one key.
//
// What bounds it on an H100: the operations. At qwen3-1.7b's prefill
// (B 8, S 2048, 16 / 8 heads, hd 128, causal) the visible pairs cost
// 1.375e11 flops against 50 MB of q, k, v and out. So both products run on
// the tensor cores, as warpgroup MMAs (wgmma.mma_async, m64nNk16, bf16 in,
// fp32 accumulate):
//   - S = Q K^T with Q and K both read from shared memory (K-major).
//     bf16 x bf16 products are exact in fp32, so S is _flash_kernel's fp32
//     dot up to the order of the sum.
//   - O += P V with P from registers (the accumulator layout of S is the
//     A-fragment layout of the next wgmma, 4 lanes of a quad per row) and V
//     from shared memory as a transposed (MN-major) B operand. P is not
//     rounded to bf16 alone: it is split as P = hi + lo, both bf16
//     (lo = bf16(P - hi)), and both go through the tensor cores against the
//     same V tile. That keeps ~16 significant bits of P (the reference
//     multiplies fp32 p by v) for 1.5x the flops of one bf16 product.
//
// Tiles. A CTA has two consumer warpgroups. The work is cut into tiles of
// 64 queries x one q head; tile t is query block t / rep and q head
// g * rep + t % rep (rep = H / KV), and a CTA takes tiles 2c and 2c + 1 of
// one (b, kv head g). At qwen3 (rep 2) that is one block of 64 queries for
// both heads that share kv head g, so each K / V tile is staged once for
// 128 rows. (Four or eight warpgroups for rep 4 or 8 would not fit their
// registers: with O, S and the two P fragments live a thread takes 238 at
// hd 128, so a CTA holds two warpgroups and rep 4 takes two CTAs.)
// CTAs run the longest causal query blocks first.
//
// The ring. K and V tiles of 64 keys sit in a 3-stage ring in shared memory,
// filled by cp.async (16 bytes a thread per copy, zero-filled past the last
// key) with a hand-written 128-byte swizzle: element (row r, col c) of a
// 64-column block lives at r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2,
// which is the layout that wgmma's 128B-swizzle descriptors read (the same
// one TMA's SWIZZLE_128B writes). hd 128 is two such blocks. All 256 threads
// copy: while tile j is computed, tile j + 1 is in flight and tile j - 1's
// V is still read; a 2-stage ring could not load ahead, and 4 stages gain
// little (tools/flash_prefill_variants.py times both). cp.async rather
// than TMA: the tensor map would have to be built per call from the
// cache's strides with libcuda's cuTensorMapEncodeTiled; cp.async reads
// through the strides as they are.
//
// The overlap. A warpgroup issues tile j's S = Q K^T and tile j - 1's
// O += P V as two wgmma groups, waits for the first, and runs tile j's
// softmax while the tensor cores still work on the second; it waits for
// the second only to rescale O and to overwrite P.
//
// The online softmax runs in registers, in the accumulator layout: thread
// (warp w, lane l) holds rows 16 w + l / 4 and 16 w + l / 4 + 8, and a row's
// 64 scores are spread over the 4 lanes of a quad, reduced with two
// shuffles. Scores are taken in base 2 (scale * log2 e folded into one
// multiply; 2^x by ex2.approx). A CTA walks only the K / V tiles that one of
// its two query tiles can see (none past the causal limit, none before the
// window); both warpgroups walk all of them, so that no wgmma sits in a
// branch (ptxas serializes wgmma there), and a tile outside a warpgroup's
// own keys is masked to nothing. Only tiles that cross a limit (the
// diagonal, a window edge, the ragged end) are masked. The finish is
// acc / max(l, 1e-30), cast to bf16 and stored through the output's strides.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success. It launches on the caller's
// stream and does not synchronise. Strides are in elements; every base
// address and every (batch, sequence, head) stride of q, k and v must be a
// multiple of 16 bytes (the caller's routing rule checks this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;      // queries per warpgroup tile
constexpr int kBKV = 64;     // keys per K / V tile
constexpr int kStages = 3;   // K / V ring depth
constexpr int kWG = 2;       // consumer warpgroups per CTA
constexpr int kThreads = 128 * kWG;
constexpr int kBlockBytes = 64 * 128;  // one 64-row x 64-column bf16 block

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int64_t Sq, rep, n_tiles;
  int64_t q_sb, q_ss, q_sh;  // strides in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t q_offset, kv_len, window;
  int causal;
  float scale_log2;  // scale * log2(e)
};

template <int HD>
struct Smem {
  static constexpr int q_tile = kBQ * HD * 2;    // bytes, one warpgroup's Q
  static constexpr int kv_tile = kBKV * HD * 2;  // bytes, K or V
  static constexpr int stage = 2 * kv_tile;
  static constexpr int bytes = kWG * q_tile + kStages * stage + 1024;  // + alignment slack
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// --- shared memory, cp.async --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk (row r, chunk c8 = col / 8) in a tile of
// HD / 64 swizzled 64-column blocks of `rows` rows
__device__ __forceinline__ uint32_t swz(int r, int c8, int rows) {
  return static_cast<uint32_t>((c8 >> 3) * rows * 128 + r * 128 + (((c8 & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy 64 rows x HD of a bf16 matrix (row j at base + j * row_stride) into a
// swizzled tile at smem address dst; rows j >= n_valid are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base,
                                          int64_t row_stride, int64_t n_valid, int tid) {
  constexpr int kChunks = 64 * HD / 8;
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (HD / 8);
    const int c8 = idx % (HD / 8);
    const bool ok = r < n_valid;
    const __nv_bfloat16* src = ok ? base + r * row_stride + c8 * 8 : base;
    cp_async16(dst + swz(r, c8, 64), src, ok);
  }
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (Q, K)
// ignore the leading byte offset; for the MN-major V it is the distance
// between the 64-column blocks of hd. The stride byte offset is the distance
// between groups of 8 rows: 8 x 128 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of r across a wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// D(64 x 64, fp32) (+)= A(64 x 16) B(16 x 64)^T, both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(0), F16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) B(16 x 64), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) B(16 x 128), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F4
#undef F16

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint32_t v_addr);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint32_t v_addr) {
  wgmma_rs_n64(o, a, desc_sw128(v_addr, kBlockBytes));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint32_t v_addr) {
  wgmma_rs_n128(o, a, desc_sw128(v_addr, kBlockBytes));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two fp32 values of P -> their bf16 hi pair and the bf16 pair of what
// hi leaves over (lo = bf16(p - hi))
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 2^x by the SFU (ex2.approx: ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += (P_hi + P_lo) V over the 64 keys of a V tile: two products of each
// 16-key slice against the same rows of V; one commit group
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(p_hi[kk]);
    fence_regs(p_lo[kk]);
  }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t v_rows = v_tile + kk * 16 * 128;  // keys 16 kk .. 16 kk + 15
    wgmma_pv<HD>(o, p_hi[kk], v_rows);
    wgmma_pv<HD>(o, p_lo[kk], v_rows);
  }
  wgmma_commit();
}

// the keys [lo, hi) any row of a tile can see
struct KeyRange {
  int64_t lo, hi;
};

__device__ __forceinline__ KeyRange tile_keys(const Args& a, int64_t tile) {
  const int64_t i0 = (tile / a.rep) * kBQ;
  const int64_t i1 = imin(i0 + kBQ, a.Sq) - 1;
  KeyRange r;
  r.hi = a.causal ? imin(a.kv_len, a.q_offset + i1 + 1) : a.kv_len;
  r.lo = a.window > 0 ? imax(0, a.q_offset + i0 - a.window + 1) : 0;
  return r;
}

// wait for this thread's copies of the next tile, make them visible to
// wgmma, and meet the other threads
template <int kS>
__device__ __forceinline__ void arrive() {
  cp_async_wait<kS - 2>();
  fence_proxy_async();
  __syncthreads();
}

// S = Q K^T over hd (one commit group)
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(q_tile + off, 0), desc_sw128(k_tile + off, 0), kk > 0);
  }
  wgmma_commit();
}

// After tile j, once every warpgroup is done with tile j - 1: copy tile
// j + kStages - 1 into tile j - 1's stage (one commit group, maybe empty).
template <int HD>
__device__ __forceinline__ void refill(uint32_t kv_base, const __nv_bfloat16* kg,
                                       const __nv_bfloat16* vg, const Args& a, int64_t kb0,
                                       int64_t hi, int j, int n_kv, int tid) {
  __syncthreads();
  const int jn = j + kStages - 1;
  if (jn < n_kv) {
    const int64_t kn = kb0 + static_cast<int64_t>(jn) * kBKV;
    const uint32_t st = kv_base + (jn % kStages) * Smem<HD>::stage;
    load_tile<HD>(st, kg + kn * a.k_ss, a.k_ss, hi - kn, tid);
    load_tile<HD>(st + Smem<HD>::kv_tile, vg + kn * a.v_ss, a.v_ss, hi - kn, tid);
  }
  cp_async_commit();
}

// S's accumulator (64 x 64, two rows a thread) -> the A fragments of P's
// bf16 hi and lo parts: keys 16 kk .. 16 kk + 15 are slice kk, whose
// fragment is (row a, keys 2q, 2q+1), (row b, same), (row a, 8 + 2q, ..),
// (row b, 8 + 2q, ..) with q = lane % 4 -- the accumulator's own order
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&p_hi)[4][4],
                                        uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_pair(p[8 * kk + 2 * e], p[8 * kk + 2 * e + 1], p_hi[kk][e], p_lo[kk][e]);
}

// The online softmax of one thread's two rows (a = 16 w + lane / 4, b = a + 8)
struct Softmax {
  int64_t iq_a, iq_first, iq_last;  // row a's position, the tile's first and last
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, base 2
  float l_a = 0.0f, l_b = 0.0f;            // this thread's share of the sums
  float corr_a = 1.0f, corr_b = 1.0f;      // the last tile's rescale of O

  // scores of keys kb .. kb + 63 -> p = 2^(s * scale log2 e - m), in place;
  // masks only a tile that crosses a limit
  __device__ __forceinline__ void scores_to_p(float (&s)[32], const Args& a, int64_t kb,
                                              int lane) {
    const bool masked = kb + kBKV > a.kv_len || (a.causal && kb + kBKV - 1 > iq_first) ||
                        (a.window > 0 && kb <= iq_last - a.window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * a.scale_log2;
        if (masked) {
          const int64_t jk = kb + 8 * n + 2 * (lane % 4) + (e & 1);
          const int64_t iq = (e < 2) ? iq_a : iq_a + 8;
          const bool ok = jk < a.kv_len && (!a.causal || jk <= iq) &&
                          (a.window <= 0 || jk > iq - a.window);
          x = ok ? x : -INFINITY;
        }
        s[4 * n + e] = x;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    // a row that has seen no key yet keeps m = -inf: exponents from 0
    const float base_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.0f : mn_b;
    corr_a = exp2_approx(m_a - base_a);
    corr_b = exp2_approx(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = exp2_approx(s[4 * n] - base_a);
      s[4 * n + 1] = exp2_approx(s[4 * n + 1] - base_a);
      s[4 * n + 2] = exp2_approx(s[4 * n + 2] - base_b);
      s[4 * n + 3] = exp2_approx(s[4 * n + 3] - base_b);
      sum_a += s[4 * n] + s[4 * n + 1];
      sum_b += s[4 * n + 2] + s[4 * n + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(const Args a) {
  using S = Smem<HD>;
  constexpr int kN = HD / 2;  // O accumulator registers a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_base = base;                      // kWG Q tiles
  const uint32_t kv_base = base + kWG * S::q_tile;   // kStages x (K tile, V tile)

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int64_t b = blockIdx.z;
  const int64_t g = blockIdx.y;
  const int64_t cta = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;  // long rows first

  // this CTA's tiles and the union of their key ranges
  const int64_t tile0 = cta * kWG;
  const int64_t tile = tile0 + wg;
  const bool active = tile < a.n_tiles;
  KeyRange cr = tile_keys(a, tile0);
  if (tile0 + 1 < a.n_tiles) {
    const KeyRange r1 = tile_keys(a, tile0 + 1);
    cr.lo = imin(cr.lo, r1.lo);
    cr.hi = imax(cr.hi, r1.hi);
  }
  const int64_t kb0 = (cr.lo / kBKV) * kBKV;
  const int n_kv = static_cast<int>((cr.hi - kb0 + kBKV - 1) / kBKV);

  const __nv_bfloat16* kg = a.k + b * a.k_sb + g * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + g * a.v_sh;

  // Q tiles of both warpgroups (with K / V tile 0 in the first copy group)
  for (int w = 0; w < kWG; ++w) {
    const int64_t tw = tile0 + w;
    const int64_t i0 = (tw / a.rep) * kBQ;
    const int64_t h = g * a.rep + tw % a.rep;
    if (tw < a.n_tiles)
      load_tile<HD>(q_base + w * S::q_tile, a.q + b * a.q_sb + i0 * a.q_ss + h * a.q_sh,
                    a.q_ss, a.Sq - i0, tid);
    else  // no tile for this warpgroup: zeros, so that its products stay finite
      load_tile<HD>(q_base + w * S::q_tile, a.q, 0, 0, tid);
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_kv) {
      const int64_t kb = kb0 + j * kBKV;
      const uint32_t st = kv_base + j * S::stage;
      load_tile<HD>(st, kg + kb * a.k_ss, a.k_ss, cr.hi - kb, tid);
      load_tile<HD>(st + S::kv_tile, vg + kb * a.v_ss, a.v_ss, cr.hi - kb, tid);
    }
    cp_async_commit();
  }

  // rows of this thread in its warpgroup's tile, and their query positions
  const int row_a = warp * 16 + lane / 4;
  const int64_t i0 = (tile / a.rep) * kBQ;
  const int64_t iq_a = a.q_offset + i0 + row_a;
  const int64_t iq_first = a.q_offset + i0;
  const int64_t iq_last = a.q_offset + imin(i0 + kBQ, a.Sq) - 1;
  const uint32_t q_tile = q_base + wg * S::q_tile;

  // Both warpgroups walk every K / V tile of the CTA: one that lies wholly
  // outside a warpgroup's keys is masked to nothing (p = 0, m and l stay).
  // Then no wgmma sits in a branch, which would make ptxas serialize them.
  float o[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) o[i] = 0.0f;
  Softmax sm;
  sm.iq_a = iq_a;
  sm.iq_first = iq_first;
  sm.iq_last = iq_last;
  float s[32];
  // P of the previous tile (bf16 hi and lo A fragments): its O += P V is
  // issued with the next tile's S = Q K^T, and the tensor cores run it
  // while this warpgroup does the next softmax
  uint32_t p_hi[4][4], p_lo[4][4];

  // tile 0
  arrive<kStages>();
  issue_s<HD>(s, q_tile, kv_base);
  wgmma_wait<0>();
  fence_regs(s);
  sm.scores_to_p(s, a, kb0, lane);
  split_p(s, p_hi, p_lo);
  refill<HD>(kv_base, kg, vg, a, kb0, cr.hi, 0, n_kv, tid);
  for (int j = 1; j < n_kv; ++j) {
    const int64_t kb = kb0 + j * kBKV;
    arrive<kStages>();
    issue_s<HD>(s, q_tile, kv_base + (j % kStages) * S::stage);
    issue_pv<HD>(o, p_hi, p_lo, kv_base + ((j - 1) % kStages) * S::stage + S::kv_tile);
    wgmma_wait<1>();  // S is done; the previous P V may still run
    fence_regs(s);
    sm.scores_to_p(s, a, kb, lane);
    wgmma_wait<0>();  // the previous P V is in O: rescale O, overwrite P
    fence_regs(o);
#pragma unroll
    for (int n = 0; n < kN / 4; ++n) {
      o[4 * n] *= sm.corr_a;
      o[4 * n + 1] *= sm.corr_a;
      o[4 * n + 2] *= sm.corr_b;
      o[4 * n + 3] *= sm.corr_b;
    }
    split_p(s, p_hi, p_lo);
    refill<HD>(kv_base, kg, vg, a, kb0, cr.hi, j, n_kv, tid);
  }
  issue_pv<HD>(o, p_hi, p_lo, kv_base + ((n_kv - 1) % kStages) * S::stage + S::kv_tile);
  wgmma_wait<0>();
  fence_regs(o);
  cp_async_wait<0>();

  if (!active) return;
  float l_a = sm.l_a, l_b = sm.l_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  const int64_t h = g * a.rep + tile % a.rep;
  const int64_t i_a = i0 + row_a;
  const int64_t i_b = i_a + 8;
  __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < kN / 4; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    if (i_a < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + i_a * a.o_ss + col) =
          __floats2bfloat162_rn(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (i_b < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + i_b * a.o_ss + col) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
}

template <int HD>
cudaError_t launch(const Args& a, int64_t B, int64_t KV, cudaStream_t stream) {
  using S = Smem<HD>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int64_t n_cta = (a.n_tiles + kWG - 1) / kWG;
  if (n_cta > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned int>(n_cta), static_cast<unsigned int>(KV),
            static_cast<unsigned int>(B));
  flash_prefill_kernel<HD><<<grid, kThreads, S::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k / v (B, Skv, KV, hd), out (B, Sq, H, hd), all bf16;
// strides in elements for the (batch, sequence, head) dims, the last dim
// contiguous; hd 64 or 128.
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v, void* out,
                                 int64_t B, int64_t Sq, int64_t H, int64_t KV, int64_t hd,
                                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                 int64_t q_offset, int64_t kv_len, int64_t window,
                                 int64_t causal, double scale, void* stream) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV != 0 || kv_len < 1 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.Sq = Sq;
  a.rep = H / KV;
  a.n_tiles = (Sq + kBQ - 1) / kBQ * a.rep;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.window = window;
  a.causal = causal != 0;
  a.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return static_cast<int>(launch<64>(a, B, KV, s));
  if (hd == 128) return static_cast<int>(launch<128>(a, B, KV, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
