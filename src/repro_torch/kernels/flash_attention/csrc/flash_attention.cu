// flash_attention forward for Hopper (sm_90a): softmax(q k^T * scale + mask) v.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//   (body _flash_kernel),
// an online softmax over KV blocks with fp32 running max m, sum l and
// accumulator acc, finished as acc / max(l, 1e-30). This kernel keeps that
// arithmetic (scores are the fp32 dot product times scale, as at
// _flash_kernel's `jnp.dot(q, k.T) * scale`) and adds what the serving path
// needs and the Pallas kernel lacks: a query offset (row i sits at absolute
// position q_offset + i) and a key count kv_len (keys jk >= kv_len are masked,
// so a decode step reads only the filled part of a KV cache).
//
// Mask of key jk for the query at iq = q_offset + i:
//   jk < kv_len  and (not causal or jk <= iq)  and (window <= 0 or jk > iq - window)
// The caller guarantees that every row sees at least one key.
//
// Layout: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), out (B, Sq, H, hd), in the
// model's own layout and read through strides (the last dim contiguous), so a
// layer's slice of the KV cache is read in place: no transposes, no padding.
// GQA: q head h reads kv head h / (H / KV). One CTA serves one (b, kv head g)
// and a block of BQ "row slots"; slot r is query i = r / rep of head
// g * rep + r % rep (rep = H / KV), so the rep heads that share a kv head share
// every K/V tile the CTA stages.
//
// What bounds it on an H100: at prefill (Sq = Skv = 2048, hd 128) the
// operations: 4 hd flops per visible (query, key) pair, against a few bytes
// per pair. At decode (Sq = 1) the bytes of the KV cache. This first version
// is simple: fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor cores'
// 989 for bf16). K/V blocks of 64 keys are staged in shared memory as fp32
// (K transposed); each of 256 threads owns a RT x 4 tile of the score block
// and a RT x hd/16 tile of the accumulator, so each shared-memory load feeds
// several FMAs. KV blocks wholly past the causal limit (or before the window)
// are skipped. For a decode step (Sq * rep <= 16) the row block shrinks to 16
// slots (RT = 1). wgmma, TMA and a split over the KV axis for decode are later
// work.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success. Launches go on the caller's stream
// and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks keys / dims
constexpr int kBKV = 64;       // keys per staged block
constexpr int kPad = 4;        // row padding of the transposed tiles (bank spread)
constexpr float kNegInf = -1e30f;

enum DType : int64_t { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
  float scale;
};

template <int HD, int RT>
struct Smem {
  static constexpr int BQ = 16 * RT;
  static constexpr int q = HD * (BQ + kPad);     // Qs[d][r]
  static constexpr int k = HD * (kBKV + kPad);   // Ks[d][j]
  static constexpr int v = kBKV * HD;            // Vs[j][d]
  static constexpr int p = BQ * (kBKV + kPad);   // Ps[r][j]
  static constexpr size_t bytes = sizeof(float) * (q + k + v + p);
};

template <typename T, int HD, int RT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  using S = Smem<HD, RT>;
  constexpr int BQ = S::BQ;
  constexpr int QS = BQ + kPad;
  constexpr int KS = kBKV + kPad;
  constexpr int DPT = (HD + 15) / 16;  // accumulator dims per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + S::q;
  float* Vs = Ks + S::k;
  float* Ps = Vs + S::v;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t b = blockIdx.z;
  const int64_t g = blockIdx.y;
  const int64_t n_rows = a.Sq * a.rep;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BQ;

  const T* __restrict__ q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* __restrict__ k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* __restrict__ v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  T* __restrict__ o = static_cast<T*>(a.o) + b * a.o_sb;

  // stage this block's query rows, transposed: Qs[d][r]
  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int rl = idx / HD;
    const int d = idx % HD;
    const int64_t r = r0 + rl;
    float x = 0.0f;
    if (r < n_rows) {
      const int64_t i = r / a.rep;
      const int64_t h = g * a.rep + r % a.rep;
      x = to_f32(q[i * a.q_ss + h * a.q_sh + d]);
    }
    Qs[d * QS + rl] = x;
  }

  // the keys any row of this block can see: [lo, hi)
  const int64_t i_min = r0 / a.rep;
  const int64_t i_max = (imin(r0 + BQ, n_rows) - 1) / a.rep;
  int64_t hi = a.kv_len;
  if (a.causal) hi = imin(hi, a.q_offset + i_max + 1);
  int64_t lo = 0;
  if (a.window > 0) lo = imax(lo, a.q_offset + i_min - a.window + 1);
  lo = (lo / kBKV) * kBKV;

  // per-row state of this thread's RT rows (identical across the 16 tx)
  int64_t iq[RT];
  bool row_ok[RT];
  float m[RT], l[RT], acc[RT][DPT];
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int64_t r = r0 + ty * RT + t;
    row_ok[t] = r < n_rows;
    iq[t] = a.q_offset + r / a.rep;
    m[t] = kNegInf;
    l[t] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[t][e] = 0.0f;
  }

  for (int64_t kb = lo; kb < hi; kb += kBKV) {
    __syncthreads();  // the previous block's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
      const int jl = idx / HD;
      const int d = idx % HD;
      const int64_t jk = kb + jl;
      float kx = 0.0f, vx = 0.0f;
      if (jk < hi) {
        kx = to_f32(k[jk * a.k_ss + d]);
        vx = to_f32(v[jk * a.v_ss + d]);
      }
      Ks[d * KS + jl] = kx;
      Vs[jl * HD + d] = vx;
    }
    __syncthreads();

    // scores of rows ty*RT + t against keys tx*4 + c
    float s[RT][4];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[t][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[d * KS + tx * 4]);
      float qq[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) qq[t] = Qs[d * QS + ty * RT + t];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        s[t][0] = fmaf(qq[t], kk.x, s[t][0]);
        s[t][1] = fmaf(qq[t], kk.y, s[t][1]);
        s[t][2] = fmaf(qq[t], kk.z, s[t][2]);
        s[t][3] = fmaf(qq[t], kk.w, s[t][3]);
      }
    }

    float corr[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t jk = kb + tx * 4 + c;
        ok[c] = row_ok[t] && jk < hi && (!a.causal || jk <= iq[t]) &&
                (a.window <= 0 || jk > iq[t] - a.window);
        s[t][c] = ok[c] ? s[t][c] * a.scale : kNegInf;
        mx = fmaxf(mx, s[t][c]);
      }
      // the row's 16 threads are one half-warp: reduce over tx
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[t], mx);
      float psum = 0.0f;
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ok[c] ? expf(s[t][c] - m_new) : 0.0f;
        psum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      corr[t] = expf(m[t] - m_new);
      l[t] = l[t] * corr[t] + psum;
      m[t] = m_new;
      *reinterpret_cast<float4*>(&Ps[(ty * RT + t) * KS + tx * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc = acc * corr + p v, dims tx + 16 e
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[t][e] *= corr[t];
    const int jmax = static_cast<int>(imin(kBKV, hi - kb));
    for (int j = 0; j < jmax; ++j) {
      float pj[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) pj[t] = Ps[(ty * RT + t) * KS + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        if (d < HD) {
          const float vv = Vs[j * HD + d];
#pragma unroll
          for (int t = 0; t < RT; ++t) acc[t][e] = fmaf(pj[t], vv, acc[t][e]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < RT; ++t) {
    if (!row_ok[t]) continue;
    const int64_t r = r0 + ty * RT + t;
    const int64_t i = r / a.rep;
    const int64_t h = g * a.rep + r % a.rep;
    const float inv = 1.0f / fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx + 16 * e;
      if (d < HD) o[i * a.o_ss + h * a.o_sh + d] = from_f32<T>(acc[t][e] * inv);
    }
  }
}

template <typename T, int HD, int RT>
cudaError_t launch(const Args& a, int64_t B, int64_t KV, cudaStream_t stream) {
  using S = Smem<HD, RT>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::bytes));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int64_t n_rows = a.Sq * a.rep;
  dim3 grid(static_cast<unsigned int>((n_rows + S::BQ - 1) / S::BQ),
            static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  flash_fwd_kernel<T, HD, RT><<<grid, kThreads, S::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rt(const Args& a, int64_t B, int64_t KV, cudaStream_t s) {
  // a decode step (a few row slots) takes the 16-slot block
  if (a.Sq * a.rep <= 16) return launch<T, HD, 1>(a, B, KV, s);
  return launch<T, HD, 4>(a, B, KV, s);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int64_t hd, int64_t B, int64_t KV, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_rt<T, 8>(a, B, KV, s);
    case 16: return launch_rt<T, 16>(a, B, KV, s);
    case 32: return launch_rt<T, 32>(a, B, KV, s);
    case 64: return launch_rt<T, 64>(a, B, KV, s);
    case 128: return launch_rt<T, 128>(a, B, KV, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KV, hd), out (B, Sq, H, hd); strides in
// elements for the (batch, sequence, head) dims, the last dim contiguous.
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
  a.scale = static_cast<float>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_hd<float>(a, hd, B, KV, s));
  if (dtype == kBF16) return static_cast<int>(launch_hd<__nv_bfloat16>(a, hd, B, KV, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
