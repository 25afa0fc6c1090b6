// wkv for Hopper (sm_90a): the rwkv6 recurrence over a per-head hd x hd state.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv/kernel.py::wkv_pallas (body _wkv_kernel),
// which keeps the state in VMEM over the whole sequence, one grid program per
// (batch, head). For every token t, in _wkv_kernel's order:
//   kv      = k_t^T v_t                                   (hd x hd)
//   out_t   = sum_k r_t[k] * (S + u o kv)[k, :]           (uses the state before the update)
//   S       = diag(w_t) S + kv                            (w scales the state's k rows)
// All in fp32. It takes an optional initial state and returns the final one,
// so a sequence run in two calls chained through the state equals one call
// (the decode path runs one token per call this way).
//
// Layout: r, k, v, w and out (B, S, H, hd) contiguous fp32; u (H, hd);
// state0 and the final state (B, H, hd, hd) as S[k][j].
//
// What bounds it on an H100: for a prompt, the operations of the token loop
// (7 separately rounded fp32 operations per state element per token; the
// whole input is read once); for one token, the bytes of the state read and
// written. The loop over tokens is sequential, and columns of the state are
// independent (out_t[j] depends only on column j), so the parallelism is the
// B * H * hd columns. The design spreads each column over four threads:
// thread (j, p) holds the rows kk = p, p + 4, p + 8, ... of column j (hd / 4
// floats) and its rows of u in registers for the whole sequence, and keeps
// the partial sum o_p of out_t[j] over those rows in increasing kk; the four
// partials of a column sit in neighbouring lanes and combine by two shuffles
// as (o0 + o1) + (o2 + o3). A thread may hold JC columns (j and j + cols / 2
// for JC = 2), so that each r, k, w value it reads from shared memory serves
// JC columns. A CTA covers `cols` columns of one (b, h), so the grid is
// (hd / cols, H, B). r, k and w of `chunk` tokens, and v of the CTA's
// columns, go into a ring of kStages = 2 shared-memory stages by cp.async,
// so chunk c + 1 loads while chunk c is computed; r, k and w are stored with row
// kk at (kk mod 4) * (hd/4 + 4) + kk / 4, so a thread's rows are contiguous
// and one 16-byte shared read serves four of them (the 4-float pad puts the
// four parts on different banks). cols, JC and chunk are chosen on the
// host (kernel.py::wkv_plan). Shared-memory reads and issue slots are
// both near their limits at the prompt shape (tools/wkv_variants.py).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), in the order of the plain version in ref.py, so
// the two agree to the bit: at S = 1024 an output near zero is the difference
// of terms near 300, where one fp32 ulp (3e-5) is already past a 1e-5 limit,
// so any other association would differ by more than the limit without either
// being wrong. For the same reason tensor cores do not apply: a chunked
// matrix form of the recurrence rounds differently.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success. Launches go on the caller's stream
// and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;          // 4 threads x 64 columns
constexpr int64_t kMaxSmem = 232448;      // 227 KB, the most one CTA may use
constexpr int kStages = 2;                // chunks in the cp.async ring (kernel.py::WKV_STAGES)

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R consecutive floats of shared memory into registers, 16 bytes at a time
// where R allows.
template <int R>
__device__ __forceinline__ void load_rows(float (&x)[R], const float* s) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + i);
      x[i] = q.x;
      x[i + 1] = q.y;
      x[i + 2] = q.z;
      x[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = s[i];
  }
}

// minBlocksPerSM 1: without it ptxas picks a register budget of its own,
// which moves with unrelated edits to this file (99 registers and a 0.41 ms
// prompt, or 64 registers and a spill at the decode plan, against 120 and
// 0.38 ms with it; tools/wkv_variants.py, edit `no_min_blocks`). Two CTAs
// an SM fit either way; shared memory limits them first.
template <int HD, int JC>
__global__ void __launch_bounds__(kMaxThreads, 1)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ out, float* __restrict__ s_out, int64_t S, int64_t H, int cols,
           int chunk) {
  constexpr int R = HD / 4;       // state rows per thread and column
  constexpr int PS = R + 4;       // floats per part in a staged row
  constexpr int ROW = 4 * PS;     // one token's r (or k, or w)
  extern __shared__ __align__(16) float ring[];
  const int tok = 3 * ROW + cols;  // one token's staged floats: r, k, w, v
  const int per = cols / JC;       // the thread's columns are jl, jl + per, ...
  const int p = threadIdx.x & 3;
  const int jl = threadIdx.x >> 2;
  const int j0 = blockIdx.x * cols;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t state_base = (b * H + h) * HD * HD;
  const int64_t tstride = H * HD;                  // one token in r, k, v, w, out
  const int64_t seq_base = (b * S * H + h) * HD;   // token 0 of (b, h)

  // chunk c of r, k, w (all hd rows) and v (this CTA's columns) into stage
  // c % kStages; one cp.async group per chunk, empty past the end
  const int64_t n_chunks = (S + chunk - 1) / chunk;
  auto stage_in = [&](int64_t c) {
    if (c < n_chunks) {
      float* st = ring + (c % kStages) * chunk * tok;
      const int64_t t0 = c * chunk;
      const int n = static_cast<int>(S - t0 < chunk ? S - t0 : chunk);
      const int64_t g0 = seq_base + t0 * tstride;
      for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
        const int t = e / HD;
        const int kk = e % HD;
        const int64_t g = g0 + t * tstride + kk;
        float* sm = st + t * tok + (kk & 3) * PS + (kk >> 2);
        cp_async4(sm, r + g);
        cp_async4(sm + ROW, k + g);
        cp_async4(sm + 2 * ROW, w + g);
      }
      // 4 * cols / JC threads: a whole number of passes over the columns
      const int jj = threadIdx.x % cols;
      for (int t = threadIdx.x / cols; t < n; t += blockDim.x / cols)
        cp_async4(st + t * tok + 3 * ROW + jj, v + g0 + t * tstride + j0 + jj);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) stage_in(c);

  float st[JC][R];  // st[c][i] = S[p + 4 i][j0 + jl + c * per]
  float uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = p + 4 * i;
    uu[i] = u[h * HD + kk];
#pragma unroll
    for (int c = 0; c < JC; ++c)
      st[c][i] = s0 ? s0[state_base + kk * HD + j0 + jl + c * per] : 0.0f;
  }

  for (int64_t c = 0; c < n_chunks; ++c) {
    stage_in(c + kStages - 1);
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const float* stage = ring + (c % kStages) * chunk * tok;
    const int64_t t0 = c * chunk;
    const int n = static_cast<int>(S - t0 < chunk ? S - t0 : chunk);
#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      const float* row = stage + t * tok;
      float vj[JC];
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) vj[cc] = row[3 * ROW + jl + cc * per];
      float rr[R], kr[R], wr[R];
      load_rows<R>(rr, row + p * PS);
      load_rows<R>(kr, row + ROW + p * PS);
      load_rows<R>(wr, row + 2 * ROW + p * PS);
      // explicit roundings, no contraction into FMAs: the plain version
      // (ref.py) rounds each product and sum in this same order
      float o[JC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int cc = 0; cc < JC; ++cc) {
          const float kv = __fmul_rn(kr[i], vj[cc]);
          const float term = __fmul_rn(rr[i], __fadd_rn(st[cc][i], __fmul_rn(uu[i], kv)));
          o[cc] = i == 0 ? term : __fadd_rn(o[cc], term);
          st[cc][i] = __fadd_rn(__fmul_rn(wr[i], st[cc][i]), kv);
        }
      }
      // lanes p = 0..3 of a column are neighbours: (o0 + o1) + (o2 + o3)
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) {
        const float pair = __fadd_rn(o[cc], __shfl_xor_sync(0xffffffffu, o[cc], 1));
        const float sum = __fadd_rn(pair, __shfl_xor_sync(0xffffffffu, pair, 2));
        if (p == 0) out[seq_base + (t0 + t) * tstride + j0 + jl + cc * per] = sum;
      }
    }
    __syncthreads();  // stage c % kStages is refilled in the next iteration
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < JC; ++c)
      s_out[state_base + (p + 4 * i) * HD + j0 + jl + c * per] = st[c][i];
}

int64_t smem_bytes(int64_t hd, int64_t cols, int64_t chunk) {
  return kStages * chunk * (3 * (hd + 16) + cols) * static_cast<int64_t>(sizeof(float));
}

template <int HD, int JC>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* out, float* s_out, int64_t B,
                   int64_t S, int64_t H, int64_t cols, int64_t chunk, cudaStream_t stream) {
  const int64_t smem = smem_bytes(HD, cols, chunk);
  static int64_t smem_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<HD, JC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  dim3 grid(static_cast<unsigned int>(HD / cols), static_cast<unsigned int>(H),
            static_cast<unsigned int>(B));
  wkv_kernel<HD, JC><<<grid, static_cast<unsigned int>(4 * cols / JC), smem, stream>>>(
      r, k, v, w, u, s0, out, s_out, S, H, static_cast<int>(cols), static_cast<int>(chunk));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const float* r, const float* k, const float* v, const float* w,
                      const float* u, const float* s0, float* out, float* s_out, int64_t B,
                      int64_t S, int64_t H, int64_t cols, int64_t jc, int64_t chunk,
                      cudaStream_t stream) {
  if (jc == 1) return launch<HD, 1>(r, k, v, w, u, s0, out, s_out, B, S, H, cols, chunk, stream);
  if (jc == 2) return launch<HD, 2>(r, k, v, w, u, s0, out, s_out, B, S, H, cols, chunk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// state0 may be null (a zero initial state). The launch plan: `cols` columns
// per CTA (it divides hd), `jc` of them per thread (1 or 2; 4 * cols / jc
// threads, whole warps), `chunk` tokens per staged chunk.
extern "C" int wkv_fwd(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* state0, float* out, float* state_out,
                       int64_t B, int64_t S, int64_t H, int64_t hd, int64_t cols, int64_t jc,
                       int64_t chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || chunk < 1 || jc < 1 ||
      cols > hd || hd % cols != 0 || cols % jc != 0 || 4 * cols / jc % 32 != 0 ||
      4 * cols / jc > kMaxThreads || smem_bytes(hd, cols, chunk) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8:
      return static_cast<int>(launch_hd<8>(r, k, v, w, u, state0, out, state_out, B, S, H, cols,
                                           jc, chunk, s));
    case 16:
      return static_cast<int>(launch_hd<16>(r, k, v, w, u, state0, out, state_out, B, S, H, cols,
                                            jc, chunk, s));
    case 32:
      return static_cast<int>(launch_hd<32>(r, k, v, w, u, state0, out, state_out, B, S, H, cols,
                                            jc, chunk, s));
    case 64:
      return static_cast<int>(launch_hd<64>(r, k, v, w, u, state0, out, state_out, B, S, H, cols,
                                            jc, chunk, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
