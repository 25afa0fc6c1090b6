// flash_attention: the general flash-attention forward for Hopper (sm_90a):
// softmax(q k^T * scale + mask) v on the tensor cores, fp32-accurate.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//   (body _flash_kernel),
// an online softmax over KV blocks with fp32 running max m, sum l and
// accumulator acc, finished as acc / max(l, 1e-30). This kernel keeps that
// arithmetic and adds what the serving path needs and the Pallas kernel
// lacks: a query offset (row i sits at absolute position q_offset + i) and a
// key count kv_len (keys jk >= kv_len are masked, so a step reads only the
// filled part of a KV cache).
//
// Mask of key jk for the query at iq = q_offset + i:
//   jk < kv_len  and (not causal or jk <= iq)  and (window <= 0 or jk > iq - window)
// The caller guarantees that every row sees at least one key.
//
// Where it runs: the route of kernel.py sends bf16 prompts at hd 64 / 128 to
// flash_prefill.cu and every aligned call with at most 16 rows per kv head to
// flash_decode.cu. This kernel takes the rest: prompts in fp32, prompts at the
// small head dims, and addresses or strides that are not multiples of 16
// bytes.
//
// What bounds it on an H100: the operations, 4 hd flops per visible (query,
// key) pair against a few bytes per pair. Both products run on the tensor
// cores as mma.sync m16n8k8 TF32 (fp32 accumulate). TF32 keeps 11
// significant bits, so an fp32 operand x is split as x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and a
// product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi ("3xTF32", the
// small terms first), which leaves |x - hi - lo|
// <= 2^-22 |x|. bf16 operands are exact in TF32: q k^T takes one product,
// p v two (p's hi and lo against an exact v). The split counts are
// Splits<T>; the bound counts (3 + 3) / 2 TF32 products per plain product in
// fp32 and (1 + 2) / 2 in bf16, at 495 TFLOP/s. mma.sync itself peaks near
// 320 TFLOP/s on an H100 (tools/mma_tf32_peak.cu), and every operand a warp
// loads is split by that warp, so the splits and the fragment loads, not the
// MMAs, fill most issue slots (tools/flash_attention_variants.py). TF32
// rounding is two integer ops on the bits, not cvt.rna.tf32.f32, which runs
// on the quarter-rate conversion pipe (4.27 against 3.35 ms measured).
//
// Sums. The MMA's fp32 accumulation is not rounded to nearest: p v summed
// over every key in the MMA accumulator was off twice as far at 2048 keys,
// and its error grows with the number of keys. So each key tile's p v
// products go into a fresh sum, added to acc in fp32; q k^T sums only
// hd / 8 k-steps and stays in the accumulator (a fresh sum per k-step there
// measured slower for a smaller gain).
//
// Rows. Slot r of a (b, kv head g) is query i = r / rep of head
// g * rep + r % rep (rep = H / KV), so the rep heads that share a kv head
// share every staged K / V tile. A warp owns 16 slots (the m16 of the MMA);
// a CTA has kWarps warps, or one warp for a call of at most 16 slots (only
// unaligned decode steps come here). CTAs take the last row blocks (the most
// keys under a causal mask) first.
//
// Registers. Thread (warp w, lane = 4 gq + tq) keeps rows gq and gq + 8 of
// its warp: Q's A fragments as fp32 (split on each use), S's C fragments, and
// the accumulator's C fragments (hd / 8 tiles of 8 dims). P never leaves the
// registers: S's C fragment holds keys 2 tq and 2 tq + 1 of each 8-key tile,
// which become A's columns tq and tq + 4 when A's column c is read as key
// 2c (c < 4) or 2 (c - 4) + 1; V's B fragment is read in the same key order
// (b0 = V[2 tq][gq], b1 = V[2 tq + 1][gq]). The p v sum over keys does not
// depend on their order.
//
// Shared memory. K and V tiles of kBKV keys go through a kStages-deep ring,
// in the input's own type, each row padded by 16 bytes: with a row stride of
// hd + 4 words (fp32) the B-fragment reads of both K (row gq, col tq) and V
// (row 2 tq, col gq) hit 32 different banks. One __syncthreads per tile: tile
// j + kStages - 1 is issued once every warp is past tile j - 1. Staging
// depends on the alignment the host sees in the byte steps (template flag
// ALIGNED): 16-byte cp.async, else 4-byte cp.async for fp32 or plain loads
// for bf16, into the same layout. Rows past the CTA's last key are
// zero-filled.
//
// Softmax in base 2 (scale * log2 e folded into one multiply), in registers;
// a row's max is reduced over its 4 lanes by two shuffles, its sum is kept
// per lane and reduced once at the end. Only tiles that cross a limit for
// some row of the warp are masked; a warp skips the tiles none of its rows
// sees, and the CTA walks only the tiles some of its rows see.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success. Launches go on the caller's stream
// and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the launch plan (kernel.py::general_plan mirrors it; the alternatives
// measured against it are edits in tools/flash_attention_variants.py)
constexpr int kWarps = 4;     // warps (16 row slots each) per CTA
constexpr int kBKV = 32;      // keys per staged K / V tile
constexpr int kStages = 3;    // tiles in the ring
constexpr float kNegInf = -1e30f;

// TF32 products per plain product: q k^T and p v
template <typename T> struct Splits;
template <> struct Splits<float> { static constexpr int qk = 3, pv = 3; };
template <> struct Splits<__nv_bfloat16> { static constexpr int qk = 1, pv = 2; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Sq, rep;
  int64_t q_sb, q_ss, q_sh;  // strides in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t q_offset, kv_len, window;
  int causal;
  float scale_log2;  // scale * log2(e)
};

template <typename T, int HD, int WARPS>
struct Plan {
  static constexpr int row_bytes = HD * static_cast<int>(sizeof(T)) + 16;
  static constexpr int RS = row_bytes / static_cast<int>(sizeof(T));  // row stride, elements
  static constexpr int tile = kBKV * row_bytes;
  static constexpr int stage = 2 * tile;  // K, then V
  static constexpr int bytes = kStages * stage;
};

// --- TF32 and mma.sync --------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// result, from two integer ops on the bits (cvt runs on the quarter-rate
// conversion pipe, and 3xTF32 needs two roundings per operand)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// an opaque copy: Q's split is the same in every tile, and the compiler would
// hoist it out of the tile loop (hi and lo of all of Q live at once: spills at
// fp32 hd 128); splitting a copy it cannot see through keeps it in the loop
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] for NC accumulators with N TF32 products each: 1 hi hi;
// 2 a_lo b_hi + hi hi (b exact); 3 a_lo b_hi + a_hi b_lo + hi hi. One kind of
// product over all NC accumulators, then the next, so that the MMAs issued
// back to back never wait on each other's accumulator; the small terms
// first (as accurate as hi hi first, tools/flash_attention_variants.py).
template <int N, int NC>
__device__ __forceinline__ void mma_products(float (*d)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const uint32_t (&bh)[NC][2],
                                             const uint32_t (&bl)[NC][2]) {
#pragma unroll
  for (int i = 0; i < NC && N >= 2; ++i) mma(d[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NC && N >= 3; ++i) mma(d[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < NC; ++i) mma(d[i], ah, bh[i][0], bh[i][1]);
}

// the hi (and, for N >= 2, lo) parts of 4 A values / 2 B values
template <int N, int M>
__device__ __forceinline__ void split_frag(const float (&x)[M], uint32_t (&hi)[M],
                                           uint32_t (&lo)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    if (N >= 2) {
      split(x[e], hi[e], lo[e]);
    } else {
      hi[e] = tf32(x[e]);
      lo[e] = 0u;
    }
  }
}

// --- staging --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K then V rows kb .. kb + kBKV - 1 into one stage; rows at or past hi read as 0
template <typename T, int HD, int WARPS, bool ALIGNED>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ k,
                                          const T* __restrict__ v, int64_t kb, int64_t hi,
                                          const Args& a, int tid) {
  constexpr int RS = Plan<T, HD, WARPS>::RS;
  constexpr int VEC = ALIGNED ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CPR = HD / VEC;  // copies per row
  constexpr int N = 2 * kBKV * CPR;
#pragma unroll 4
  for (int idx = tid; idx < N; idx += WARPS * 32) {
    const int which = idx / (kBKV * CPR);  // 0 K, 1 V
    const int j = idx / CPR % kBKV;
    const int c = idx % CPR;
    const int64_t jk = kb + j;
    const bool ok = jk < hi;
    const T* base = which ? v : k;
    const T* src = ok ? base + jk * (which ? a.v_ss : a.k_ss) + c * VEC : base;
    T* d = dst + which * kBKV * RS + j * RS + c * VEC;
    if constexpr (ALIGNED) {
      cp_async16(d, src, ok);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(d, src, ok);
    } else {
      *d = ok ? *src : from_f32<T>(0.0f);
    }
  }
}

// --- the kernel -------------------------------------------------------------------

template <typename T, int HD, int WARPS, bool ALIGNED>
__global__ void __launch_bounds__(WARPS * 32, 8 / WARPS) flash_tc_kernel(const Args a) {
  using P = Plan<T, HD, WARPS>;
  constexpr int RS = P::RS;
  constexpr int KD = HD / 8;    // k-steps of q k^T; dim tiles of p v
  constexpr int NT = kBKV / 8;  // key tiles of q k^T; k-steps of p v
  constexpr int DG = KD < 2 ? KD : 2;  // dim tiles per group of p v MMAs
  constexpr int BQ = WARPS * 16;
  constexpr int QK = Splits<T>::qk;
  constexpr int PV = Splits<T>::pv;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int64_t b = blockIdx.z;
  const int64_t g = blockIdx.y;
  const int64_t n_rows = a.Sq * a.rep;
  const int64_t r0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;

  const T* __restrict__ q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* __restrict__ k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* __restrict__ v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  T* __restrict__ o = static_cast<T*>(a.o) + b * a.o_sb;

  // the keys some row of this CTA sees: [lo, hi), lo on a tile boundary
  const int64_t i_min = r0 / a.rep;
  const int64_t i_max = (imin(r0 + BQ, n_rows) - 1) / a.rep;
  int64_t hi = a.kv_len;
  if (a.causal) hi = imin(hi, a.q_offset + i_max + 1);
  int64_t lo = 0;
  if (a.window > 0) lo = imax(lo, a.q_offset + i_min - a.window + 1);
  lo = lo / kBKV * kBKV;
  const int n_tiles = static_cast<int>((hi - lo + kBKV - 1) / kBKV);

  // start the ring before anything else
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<T, HD, WARPS, ALIGNED>(ring + s * 2 * kBKV * RS, k, v, lo + s * kBKV, hi, a,
                                       tid);
    cp_async_commit();
  }

  // this warp's rows: slots wr0 .. wr0 + 15; the thread keeps gq and gq + 8
  const int64_t wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < n_rows;
  const int64_t wi_min = wr0 / a.rep;
  const int64_t wi_max = (imin(wr0 + 16, n_rows) - 1) / a.rep;
  int64_t whi = a.kv_len;
  if (a.causal) whi = imin(whi, a.q_offset + wi_max + 1);
  const int64_t wlo = a.window > 0 ? a.q_offset + wi_min - a.window + 1 : 0;
  int64_t iq[2];
  const T* qrow[2];
  bool row_ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int64_t r = wr0 + gq + 8 * h2;
    row_ok[h2] = r < n_rows;
    const int64_t i = r / a.rep;
    iq[h2] = a.q_offset + i;
    qrow[h2] = q + i * a.q_ss + (g * a.rep + r % a.rep) * a.q_sh;
  }

  // Q: A fragments (a0 row gq col tq, a1 row gq+8 col tq, a2 / a3 col tq + 4)
  float qf[KD][4];
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h2 = e & 1;
      qf[ks][e] = row_ok[h2] ? to_f32(qrow[h2][ks * 8 + tq + 4 * (e >> 1)]) : 0.0f;
    }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this lane's part of the row sum
  float acc[KD][4];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j has landed; every warp is past tile j - 1
    {
      const int jn = j + kStages - 1;
      if (jn < n_tiles)
        load_tile<T, HD, WARPS, ALIGNED>(ring + (jn % kStages) * 2 * kBKV * RS, k, v,
                                         lo + static_cast<int64_t>(jn) * kBKV, hi, a, tid);
      cp_async_commit();
    }
    const T* Ks = ring + (j % kStages) * 2 * kBKV * RS;
    const T* Vs = Ks + kBKV * RS;
    const int64_t kb = lo + static_cast<int64_t>(j) * kBKV;
    if (!warp_live || kb >= whi || kb + kBKV <= wlo) continue;

    // S = Q K^T (key tile nt holds keys kb + 8 nt + 2 tq, + 1 in c0 / c1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      float qx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) qx[e] = opaque(qf[ks][e]);
      uint32_t ah[4], al[4];
      split_frag<QK>(qx, ah, al);
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int at = (nt * 8 + gq) * RS + ks * 8 + tq;
        const float kx[2] = {to_f32(Ks[at]), to_f32(Ks[at + 4])};
        split_frag<QK>(kx, bh[nt], bl[nt]);
      }
      mma_products<QK, NT>(s, ah, al, bh, bl);
    }

    // online softmax, rows gq (c0, c1) and gq + 8 (c2, c3)
    const bool full = kb + kBKV <= a.kv_len &&
                      (!a.causal || kb + kBKV - 1 <= a.q_offset + wi_min) &&
                      (a.window <= 0 || kb > a.q_offset + wi_max - a.window);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = m[h2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[nt][2 * h2 + c] * a.scale_log2;
          if (!full) {
            const int64_t jk = kb + nt * 8 + 2 * tq + c;
            const bool ok = jk < a.kv_len && (!a.causal || jk <= iq[h2]) &&
                            (a.window <= 0 || jk > iq[h2] - a.window);
            x = ok ? x : kNegInf;
          }
          s[nt][2 * h2 + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = kNegInf and p = 0
      const float m_use = mx == kNegInf ? 0.0f : mx;
      const float corr = exp2f(m[h2] - m_use);
      m[h2] = mx;
      float psum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[nt][2 * h2 + c] - m_use);
          s[nt][2 * h2 + c] = p;
          psum += p;
        }
      l[h2] = l[h2] * corr + psum;
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        acc[dn][2 * h2] *= corr;
        acc[dn][2 * h2 + 1] *= corr;
      }
    }

    // acc += P V: A column tq is key 2 tq, column tq + 4 key 2 tq + 1. The
    // dim tiles in groups of DG, each group over the tile's NT k-steps into
    // a fresh sum, added to acc in fp32
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float px[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      split_frag<PV>(px, ph[kk], pl[kk]);
    }
#pragma unroll
    for (int d0 = 0; d0 < KD; d0 += DG) {
      float f[DG][4];
#pragma unroll
      for (int i = 0; i < DG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[i][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t bh[DG][2], bl[DG][2];
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int at = (kk * 8 + 2 * tq) * RS + (d0 + i) * 8 + gq;
          const float vx[2] = {to_f32(Vs[at]), to_f32(Vs[at + RS])};
          split_frag<(PV >= 3 ? 2 : 1)>(vx, bh[i], bl[i]);
        }
        mma_products<PV, DG>(f, ph[kk], pl[kk], bh, bl);
      }
#pragma unroll
      for (int i = 0; i < DG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d0 + i][e] += f[i][e];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lsum = l[h2];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    if (!row_ok[h2]) continue;
    const int64_t r = wr0 + gq + 8 * h2;
    T* orow = o + (r / a.rep) * a.o_ss + (g * a.rep + r % a.rep) * a.o_sh;
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) {
      orow[dn * 8 + 2 * tq] = from_f32<T>(acc[dn][2 * h2] * inv);
      orow[dn * 8 + 2 * tq + 1] = from_f32<T>(acc[dn][2 * h2 + 1] * inv);
    }
  }
}

template <typename T, int HD, int WARPS, bool ALIGNED>
cudaError_t launch(const Args& a, int64_t B, int64_t KV, cudaStream_t stream) {
  using P = Plan<T, HD, WARPS>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_kernel<T, HD, WARPS, ALIGNED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int64_t n_rows = a.Sq * a.rep;
  const int64_t blocks = (n_rows + WARPS * 16 - 1) / (WARPS * 16);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(KV),
            static_cast<unsigned int>(B));
  flash_tc_kernel<T, HD, WARPS, ALIGNED><<<grid, WARPS * 32, P::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_plan(const Args& a, bool aligned, int64_t B, int64_t KV, cudaStream_t s) {
  // at most 16 slots (an unaligned decode step): one warp, the unaligned staging
  if (a.Sq * a.rep <= 16) return launch<T, HD, 1, false>(a, B, KV, s);
  if (aligned) return launch<T, HD, kWarps, true>(a, B, KV, s);
  return launch<T, HD, kWarps, false>(a, B, KV, s);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int64_t hd, bool aligned, int64_t B, int64_t KV,
                      cudaStream_t s) {
  switch (hd) {
    case 8: return launch_plan<T, 8>(a, aligned, B, KV, s);
    case 16: return launch_plan<T, 16>(a, aligned, B, KV, s);
    case 32: return launch_plan<T, 32>(a, aligned, B, KV, s);
    case 64: return launch_plan<T, 64>(a, aligned, B, KV, s);
    case 128: return launch_plan<T, 128>(a, aligned, B, KV, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KV, hd), out (B, Sq, H, hd); strides in
// elements for the (batch, sequence, head) dims, the last dim contiguous.
// K / V are staged by 16-byte copies when every base address and every
// (batch, sequence, head) stride of q, k and v is a multiple of 16 bytes
// (the bytes that kernel.py::route reads), else element by element.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int64_t B, int64_t Sq, int64_t H, int64_t KV, int64_t hd,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                   int64_t q_offset, int64_t kv_len, int64_t window,
                                   int64_t causal, double scale, int64_t dtype, void* stream) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV != 0 || kv_len < 1 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.Sq = Sq;
  a.rep = H / KV;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.window = window;
  a.causal = causal != 0;
  a.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  const int64_t size = dtype == 0 ? 4 : 2;
  const int64_t steps[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) aligned = aligned && (steps[i] * size) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_hd<float>(a, hd, aligned, B, KV, s));
  return static_cast<int>(launch_hd<__nv_bfloat16>(a, hd, aligned, B, KV, s));
}
