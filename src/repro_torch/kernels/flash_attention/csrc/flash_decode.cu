// flash_decode: the split-KV flash-attention forward for Hopper (sm_90a),
// for at most 16 rows per kv head (a decode step: Sq x H / KV <= 16), fp32
// or bf16, hd 8 to 128: softmax(q k^T * scale + mask) v.
//
// Replaces, for decode steps, the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//   (body _flash_kernel),
// an online softmax over KV blocks with fp32 running max m, sum l and
// accumulator acc. The masks, the query offset and the key count are those
// of flash_attention.cu: key jk is seen by the query at iq = q_offset + i when
//   jk < kv_len  and (not causal or jk <= iq)  and (window <= 0 or jk > iq - window),
// each row with its own limits. The caller guarantees that every row sees
// at least one key.
//
// What bounds it on an H100: the bytes of the KV cache (68 MB at qwen3-1.7b's
// decode over ~2081 positions, 20 us at 3.35 TB/s); the flops are ~1 per byte.
// The TPU kernel's sequential grid over KV blocks would leave this card
// nearly idle at decode (B x KV = 64 blocks at qwen3 for 132 SMs), so the
// keys are split:
//   - The grid is (split, kv head g, b). The caller picks the split count
//     from the number of keys and the SM count (~2 CTAs per SM: at qwen3's
//     decode 5 splits measured faster than 9 or 17); split s
//     takes keys [lo + s * chunk, lo + (s + 1) * chunk) of the keys [lo, hi)
//     that any row sees.
//   - A CTA of 128 threads streams its slice in tiles of 64 keys (128 for
//     hd 8 in bf16) through the model's strides: each key row is read by
//     hd / VE lanes with one 16-byte load each (VE = 8 bf16 or 4 fp32), and
//     every thread has all of its K (or V) loads of a tile in flight at
//     once. Where the registers allow (the qwen3 shape does), the next
//     tile's K loads are issued as soon as this tile's scores are taken,
//     its V loads as soon as p v is folded in.
//   - All rows (<= 16) of the (b, g) group share each K / V vector; q sits in
//     shared memory as fp32. Scores (fp32 dot, reduced over the key's lanes
//     with shuffles, times scale) go to shared memory; one warp per row takes
//     the tile's max, p = exp(s - m) and the sum; each thread then folds
//     p v into its fp32 partial accumulator for its keys and its 16 bytes of
//     hd. The key groups' partials are summed in a fixed order at the end.
//   - With one split the CTA writes acc / max(l, 1e-30) in the output dtype.
//     With more, it writes fp32 partials (m, l, acc[hd]) to a workspace that
//     the caller allocates, and a second, small launch combines them per
//     (b, g, row, dim) in split order 0, 1, ...: M = max m_s,
//     out = sum exp(m_s - M) acc_s / max(sum exp(m_s - M) l_s, 1e-30)
//     (the l sum in a fixed butterfly order across one warp's lanes).
//     The order is fixed, so the output is the same from run to run.
//   - A split in which a row sees no key leaves that row's m = -inf and
//     l = 0 (no exponent is taken from -inf), and the combine skips it.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launches, 0 on success. It launches on the caller's
// stream and does not synchronise. Strides are in elements; the base
// addresses and the (batch, sequence, head) strides of k and v must be
// multiples of 16 bytes (the caller's routing rule checks this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;  // the combine's shared weights

enum DType : int64_t { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;  // n_split > 1: acc [groups][n_split][n_rows][hd], then m and l [.][.][n_rows]
  int64_t rep, n_rows, KV, n_split, chunk, lo, hi;
  int64_t q_sb, q_ss, q_sh;  // strides in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t q_offset, kv_len, window;
  int causal;
  float scale;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// row r of the (b, g) group: query r / rep of q head g * rep + r % rep
__device__ __forceinline__ int64_t row_query(const Args& a, int r) { return r / a.rep; }
__device__ __forceinline__ int64_t row_head(const Args& a, int64_t g, int r) {
  return g * a.rep + r % a.rep;
}

// this thread's rows of a tile: keys kb + kg + NKG u (zeros past s1)
template <int NKG, int KPT, typename T>
__device__ __forceinline__ void load_rows(uint4 (&x)[KPT], const T* base, int64_t stride,
                                          int64_t kb, int64_t s1, int kg) {
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int64_t j = kb + kg + NKG * u;
    x[u] = j < s1 ? __ldg(reinterpret_cast<const uint4*>(base + j * stride))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int HD, int ROWS>
struct Shape {
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte load
  static constexpr int NDV = HD / VE;                           // lanes per key row
  static constexpr int NKG = kThreads / NDV;                    // key groups
  static constexpr int TK = NKG > 64 ? NKG : 64;                // keys per tile
  static constexpr int KPT = TK / NKG;                          // keys a thread per tile
  static constexpr int A = ROWS * (HD + TK);                    // q_s + p_s
  static constexpr int R = kWarps * ROWS * HD;                  // per-warp partials
  static constexpr int BUF = A > R ? A : R;
  // Load the next tile's K and V during this tile's work when the
  // registers allow: the partial accumulators plus three tiles' worth of
  // K / V vectors (4 registers each) stay within ~144 a thread; else each
  // tile's loads are issued at its start (no spills either way).
  static constexpr bool PREFETCH = ROWS * VE + 12 * KPT <= 144;
};

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(const Args a) {
  using Sh = Shape<T, HD, ROWS>;
  constexpr int VE = Sh::VE, NDV = Sh::NDV, NKG = Sh::NKG, TK = Sh::TK, KPT = Sh::KPT;
  static_assert(NDV >= 1 && NDV <= 32 && (32 % NDV) == 0, "a key row spans 1..32 lanes");

  __shared__ __align__(16) float buf[Sh::BUF];
  __shared__ float m_s[ROWS], l_s[ROWS], c_s[ROWS];
  __shared__ int64_t lo_s[ROWS], hi_s[ROWS];
  float* q_s = buf;              // [ROWS][HD] fp32
  float* p_s = buf + ROWS * HD;  // [ROWS][TK] scores, then p
  float* red = buf;              // [kWarps][ROWS][HD] after the key loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kg = tid / NDV;
  const int dv = tid % NDV;
  const int64_t split = blockIdx.x;
  const int64_t g = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t s0 = a.lo + split * a.chunk;
  const int64_t s1 = imin(a.hi, s0 + a.chunk);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh + dv * VE;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh + dv * VE;

  for (int idx = tid; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    float x = 0.0f;
    if (r < a.n_rows)
      x = to_f32(q[row_query(a, r) * a.q_ss + row_head(a, g, r) * a.q_sh + idx % HD]);
    q_s[idx] = x;
  }
  if (tid < ROWS) {
    // row tid's keys [lo_s, hi_s); a padding row sees none
    const int64_t iq = a.q_offset + row_query(a, tid);
    hi_s[tid] = tid < a.n_rows ? (a.causal ? imin(a.kv_len, iq + 1) : a.kv_len) : 0;
    lo_s[tid] = a.window > 0 ? imax(0, iq - a.window + 1) : 0;
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  float acc[ROWS][VE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.0f;

  // every K and V load of a tile in flight at once; with PREFETCH the next
  // tile's K is loaded once this tile's scores are taken, its V once p v is
  // folded in
  uint4 kr[KPT], vr[KPT];
  if (Sh::PREFETCH) {
    load_rows<NKG>(kr, k, a.k_ss, s0, s1, kg);
    load_rows<NKG>(vr, v, a.v_ss, s0, s1, kg);
  }
  for (int64_t kb = s0; kb < s1; kb += TK) {
    if (!Sh::PREFETCH) {
      load_rows<NKG>(kr, k, a.k_ss, kb, s1, kg);
      load_rows<NKG>(vr, v, a.v_ss, kb, s1, kg);
    }
    // scores
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      float kx[VE];
      unpack(kr[u], kx);
      const int64_t j = kb + kg + NKG * u;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * HD + dv * VE);
        float part = 0.0f;
#pragma unroll
        for (int e4 = 0; e4 < VE / 4; ++e4) {
          const float4 qq = qr[e4];
          part = fmaf(qq.x, kx[4 * e4], part);
          part = fmaf(qq.y, kx[4 * e4 + 1], part);
          part = fmaf(qq.z, kx[4 * e4 + 2], part);
          part = fmaf(qq.w, kx[4 * e4 + 3], part);
        }
#pragma unroll
        for (int off = NDV / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (dv == 0) {
          const bool ok = j < s1 && j >= lo_s[r] && j < hi_s[r];
          p_s[r * TK + kg + NKG * u] = ok ? part * a.scale : -INFINITY;
        }
      }
    }
    if (Sh::PREFETCH) load_rows<NKG>(kr, k, a.k_ss, kb + TK, s1, kg);
    __syncthreads();
    // softmax statistics, one warp per row
    for (int r = warp; r < ROWS; r += kWarps) {
      float mx = -INFINITY;
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, p_s[r * TK + c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float corr = 1.0f, sum = 0.0f;
      if (m_new == -INFINITY) {  // no key of this row yet
        for (int c = lane; c < TK; c += 32) p_s[r * TK + c] = 0.0f;
      } else {
        corr = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        for (int c = lane; c < TK; c += 32) {
          const float x = p_s[r * TK + c];
          const float p = x == -INFINITY ? 0.0f : expf(x - m_new);
          p_s[r * TK + c] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + p v over this thread's keys and 16 bytes of hd
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float c = c_s[r];
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] *= c;
    }
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      float vx[VE];
      unpack(vr[u], vx);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = p_s[r * TK + kg + NKG * u];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
      }
    }
    if (Sh::PREFETCH) load_rows<NKG>(vr, v, a.v_ss, kb + TK, s1, kg);
    __syncthreads();  // p_s and c_s are rewritten by the next tile
  }

  // sum the key groups: within a warp (lanes of one dv), then warps 0..3
#pragma unroll
  for (int off = NDV; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
  if (lane < NDV) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < VE; ++e) red[(warp * ROWS + r) * HD + dv * VE + e] = acc[r][e];
  }
  __syncthreads();

  const int64_t group = b * a.KV + g;
  for (int idx = tid; idx < a.n_rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    float s = red[r * HD + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(w * ROWS + r) * HD + d];
    if (a.n_split == 1) {
      T* o = static_cast<T*>(a.o) + b * a.o_sb + row_query(a, r) * a.o_ss +
             row_head(a, g, r) * a.o_sh;
      o[d] = from_f32<T>(s / fmaxf(l_s[r], 1e-30f));
    } else {
      const int64_t row = (group * a.n_split + split) * a.n_rows + r;
      const int64_t n_all = a.KV * gridDim.z * a.n_split * a.n_rows;
      a.ws[row * HD + d] = s;
      if (d == 0) {
        a.ws[n_all * HD + row] = m_s[r];
        a.ws[n_all * (HD + 1) + row] = l_s[r];
      }
    }
  }
}

// One CTA per (g, b): each row's M = max m_s and weights w_s = exp(m_s - M)
// (0 for a split that saw no key of the row) go to shared memory, one warp
// per row; then every (row, dim) sums w_s acc_s over the splits in order.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_decode_combine_kernel(const Args a,
                                                                        int64_t n_all) {
  __shared__ float w_s[kMaxSplits][16];
  __shared__ float inv_s[16];
  const int64_t g = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t first = (b * a.KV + g) * a.n_split * a.n_rows;  // split 0, row 0
  const float* acc = a.ws;
  const float* m = a.ws + n_all * HD;
  const float* l = a.ws + n_all * (HD + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < a.n_rows; r += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < a.n_split; s += 32) mx = fmaxf(mx, m[first + s * a.n_rows + r]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int s = lane; s < a.n_split; s += 32) {
      const float ms = m[first + s * a.n_rows + r];
      const float w = ms == -INFINITY ? 0.0f : expf(ms - mx);
      w_s[s][r] = w;
      den = fmaf(w, l[first + s * a.n_rows + r], den);
    }
    den = warp_sum(den);
    if (lane == 0) inv_s[r] = 1.0f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < a.n_rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    float num = 0.0f;
#pragma unroll 4
    for (int s = 0; s < a.n_split; ++s)
      num = fmaf(w_s[s][r], acc[(first + s * a.n_rows + r) * HD + d], num);
    T* o = static_cast<T*>(a.o) + b * a.o_sb + row_query(a, r) * a.o_ss +
           row_head(a, g, r) * a.o_sh;
    o[d] = from_f32<T>(num * inv_s[r]);
  }
}

template <typename T, int HD, int ROWS>
cudaError_t launch(const Args& a, int64_t B, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned int>(a.n_split), static_cast<unsigned int>(a.KV),
            static_cast<unsigned int>(B));
  flash_decode_split_kernel<T, HD, ROWS><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const int64_t n_all = B * a.KV * a.n_split * a.n_rows;
  dim3 grid2(static_cast<unsigned int>(a.KV), static_cast<unsigned int>(B));
  flash_decode_combine_kernel<T, HD><<<grid2, kThreads, 0, stream>>>(a, n_all);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rows(const Args& a, int64_t B, cudaStream_t s) {
  if (a.n_rows <= 2) return launch<T, HD, 2>(a, B, s);
  if (a.n_rows <= 4) return launch<T, HD, 4>(a, B, s);
  if (a.n_rows <= 8) return launch<T, HD, 8>(a, B, s);
  return launch<T, HD, 16>(a, B, s);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int64_t hd, int64_t B, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_rows<T, 8>(a, B, s);
    case 16: return launch_rows<T, 16>(a, B, s);
    case 32: return launch_rows<T, 32>(a, B, s);
    case 64: return launch_rows<T, 64>(a, B, s);
    case 128: return launch_rows<T, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k / v (B, Skv, KV, hd), out (B, Sq, H, hd); strides in
// elements for the (batch, sequence, head) dims, the last dim contiguous.
// Sq * H / KV <= 16. ws: n_split > 1: B * KV * n_split * Sq * (H / KV) * (hd + 2)
// fp32 values; unused with one split.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* out,
                                void* ws, int64_t B, int64_t Sq, int64_t H, int64_t KV,
                                int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                int64_t q_offset, int64_t kv_len, int64_t window,
                                int64_t causal, double scale, int64_t dtype,
                                int64_t n_split, void* stream) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV != 0 || kv_len < 1 || B > 65535 || KV > 65535 ||
      Sq * (H / KV) > 16 || n_split < 1 || n_split > kMaxSplits ||
      (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.ws = static_cast<float*>(ws);
  a.rep = H / KV;
  a.n_rows = Sq * a.rep;
  a.KV = KV;
  a.n_split = n_split;
  // the keys any row sees: from the first row's window start to the last
  // row's causal limit
  a.hi = causal ? (kv_len < q_offset + Sq ? kv_len : q_offset + Sq) : kv_len;
  a.lo = window > 0 ? (q_offset - window + 1 > 0 ? q_offset - window + 1 : 0) : 0;
  if (a.hi <= a.lo) return static_cast<int>(cudaErrorInvalidValue);
  a.chunk = (a.hi - a.lo + n_split - 1) / n_split;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.window = window;
  a.causal = causal != 0;
  a.scale = static_cast<float>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_hd<float>(a, hd, B, s));
  if (dtype == kBF16) return static_cast<int>(launch_hd<__nv_bfloat16>(a, hd, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
