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
// What bounds it on an H100: the loop over tokens is sequential, so the
// latency of one token's step, not bytes or flops (the whole input is read
// once: ~7 flops and 4 bytes per state element per token against 16 bytes
// per hd-vector element). The design keeps that step short and out of device
// memory: one CTA per (b, h) with hd threads; thread j holds column j of the
// state in registers (hd floats) for the whole sequence. r, k, v and w are
// staged in shared memory kChunk tokens at a time with coalesced loads, so the
// token loop runs on registers and broadcast shared-memory reads, with one
// barrier pair per chunk rather than per token. out_t[j] is accumulated in 4
// independent partial sums (k = 0, 4, 8, ... into the first, k = 1, 5, ...
// into the second, and so on, then (o0 + o1) + (o2 + o3)) to shorten the
// dependent chain. Every product and sum is rounded on its own, in the order
// of the plain version in ref.py, so the two agree to the bit: at S = 1024 an
// output near zero is the difference of terms near 300, where one fp32 ulp
// (3e-5) is already past a 1e-5 limit, so any other association would differ
// by more than the limit without either being wrong.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch, 0 on success. Launches go on the caller's stream
// and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // tokens staged per barrier pair

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ out, float* __restrict__ s_out, int64_t S, int64_t H) {
  __shared__ float rs[kChunk][HD];
  __shared__ float ks[kChunk][HD];
  __shared__ float ws[kChunk][HD];
  __shared__ float vs[kChunk][HD];  // each thread reads only its own column
  __shared__ float us[HD];

  const int j = threadIdx.x;
  const int64_t h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t state_base = (b * H + h) * HD * HD;

  float st[HD];  // column j of the state: st[kk] = S[kk][j]
#pragma unroll
  for (int kk = 0; kk < HD; ++kk) st[kk] = s0 ? s0[state_base + kk * HD + j] : 0.0f;
  us[j] = u[h * HD + j];

  for (int64_t t0 = 0; t0 < S; t0 += kChunk) {
    const int n = static_cast<int>(S - t0 < kChunk ? S - t0 : kChunk);
    __syncthreads();  // the previous chunk is no longer read
    for (int c = 0; c < n; ++c) {
      const int64_t idx = ((b * S + t0 + c) * H + h) * HD + j;
      rs[c][j] = r[idx];
      ks[c][j] = k[idx];
      ws[c][j] = w[idx];
      vs[c][j] = v[idx];
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float vc = vs[c][j];
      // explicit roundings, no contraction into FMAs: the plain version
      // (ref.py) rounds each product and sum in this same order
      float o[4];
#pragma unroll
      for (int kk = 0; kk < HD; ++kk) {
        const float kv = __fmul_rn(ks[c][kk], vc);
        const float term = __fmul_rn(rs[c][kk], __fadd_rn(st[kk], __fmul_rn(us[kk], kv)));
        o[kk % 4] = kk < 4 ? term : __fadd_rn(o[kk % 4], term);
        st[kk] = __fadd_rn(__fmul_rn(ws[c][kk], st[kk]), kv);
      }
      out[((b * S + t0 + c) * H + h) * HD + j] =
          __fadd_rn(__fadd_rn(o[0], o[1]), __fadd_rn(o[2], o[3]));
    }
  }
#pragma unroll
  for (int kk = 0; kk < HD; ++kk) s_out[state_base + kk * HD + j] = st[kk];
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* out, float* s_out, int64_t B,
                   int64_t S, int64_t H, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned int>(H), static_cast<unsigned int>(B));
  wkv_kernel<HD><<<grid, HD, 0, stream>>>(r, k, v, w, u, s0, out, s_out, S, H);
  return cudaGetLastError();
}

}  // namespace

// state0 may be null (a zero initial state).
extern "C" int wkv_fwd(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* state0, float* out, float* state_out,
                       int64_t B, int64_t S, int64_t H, int64_t hd, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return static_cast<int>(launch<8>(r, k, v, w, u, state0, out, state_out, B, S, H, s));
    case 16: return static_cast<int>(launch<16>(r, k, v, w, u, state0, out, state_out, B, S, H, s));
    case 32: return static_cast<int>(launch<32>(r, k, v, w, u, state0, out, state_out, B, S, H, s));
    case 64: return static_cast<int>(launch<64>(r, k, v, w, u, state0, out, state_out, B, S, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
