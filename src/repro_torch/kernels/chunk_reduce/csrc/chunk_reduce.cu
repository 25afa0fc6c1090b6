// chunk_reduce for Hopper (sm_90a): the AllReduce combine op.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/chunk_reduce/kernel.py::chunk_reduce_pallas (body _kernel),
// which sums a (W, N) stack of partial buffers into one (N,) buffer with fp32
// accumulation and one cast to the output type.
//
// Two entry points, both for fp32 and bf16 data:
//   chunk_reduce        out[n]     = sum_w in[w, n]                 (W-way form)
//   chunk_reduce_pairs  buf[dst_j] = buf[dst_j] + buf[src_j]  for every pair j
//                       (in-place pair form: one reduce-scatter hop or the
//                       straggler fold of the port's collectives)
// Both accumulate in fp32 and round to the output type once.
//
// What bounds it on an H100: bytes of device memory. Each output element costs
// W (or 2) loads and one store and a handful of adds, far below the ~295
// operations per byte where the card would be compute-bound. The design does
// the one thing that matters for a byte-bound stream: every input byte is read
// once and every output byte written once, in 16-byte vectors (4 fp32 or 8 bf16
// per thread), neighbouring threads on neighbouring addresses, with the W-way
// sum kept in registers. The grid is sized to fill all SMs (a few blocks each)
// and strides over the vectors, so one launch covers any N. A row whose length
// or base address does not allow 16-byte vectors takes the scalar instance of
// the same template (VEC = 1).
//
// Plain C interface (bound with ctypes); each entry point returns the
// cudaError_t of its launch, 0 on success. Launches go on the caller's stream
// and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads = the SM's 2048-thread limit

enum DType : int64_t { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T moved as one aligned access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_kernel(const Tin* __restrict__ in, Tout* __restrict__ out, int64_t W, int64_t N) {
  const int64_t nvec = N / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int64_t w = 0; w < W; ++w) {
      const Vec<Tin, VEC> x = reinterpret_cast<const Vec<Tin, VEC>*>(in + w * N)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(x.v[k]);
    }
    Vec<Tout, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<Tout>(acc[k]);
    reinterpret_cast<Vec<Tout, VEC>*>(out)[i] = o;
  }
}

// blockIdx.y picks the pair; the x dimension strides over the row's vectors.
// The caller guarantees that no row is both a source and a destination and
// that no destination repeats, so the pairs never race.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_pairs_kernel(T* buf, const int64_t* __restrict__ dst,
                          const int64_t* __restrict__ src, int64_t C) {
  const int64_t j = blockIdx.y;
  Vec<T, VEC>* d = reinterpret_cast<Vec<T, VEC>*>(buf + dst[j] * C);
  const Vec<T, VEC>* s = reinterpret_cast<const Vec<T, VEC>*>(buf + src[j] * C);
  const int64_t nvec = C / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const Vec<T, VEC> a = d[i];
    const Vec<T, VEC> b = s[i];
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(to_f32(a.v[k]) + to_f32(b.v[k]));
    d[i] = o;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

unsigned int grid_for(int64_t nvec, int64_t max_blocks) {
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <typename Tin, typename Tout>
cudaError_t launch_reduce(const void* in, void* out, int64_t W, int64_t N, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(Tin);
  const bool vec_ok = N % VEC == 0 && aligned(in, 16) && aligned(out, sizeof(Tout) * VEC);
  const int64_t max_blocks = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  const auto* x = static_cast<const Tin*>(in);
  auto* y = static_cast<Tout*>(out);
  if (vec_ok) {
    chunk_reduce_kernel<Tin, Tout, VEC>
        <<<grid_for(N / VEC, max_blocks), kThreads, 0, stream>>>(x, y, W, N);
  } else {
    chunk_reduce_kernel<Tin, Tout, 1><<<grid_for(N, max_blocks), kThreads, 0, stream>>>(x, y, W, N);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pairs(void* buf, const int64_t* dst, const int64_t* src, int64_t P, int64_t C,
                         cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = C % VEC == 0 && aligned(buf, 16);
  const int64_t per_pair = (static_cast<int64_t>(sm_count()) * kBlocksPerSm + P - 1) / P;
  auto* b = static_cast<T*>(buf);
  const int64_t nvec = vec_ok ? C / VEC : C;
  dim3 grid(grid_for(nvec, per_pair), static_cast<unsigned int>(P));
  if (vec_ok) {
    chunk_reduce_pairs_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(b, dst, src, C);
  } else {
    chunk_reduce_pairs_kernel<T, 1><<<grid, kThreads, 0, stream>>>(b, dst, src, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int chunk_reduce(const void* in, void* out, int64_t W, int64_t N, int64_t in_dtype,
                            int64_t out_dtype, void* stream) {
  if (W < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32)
    return static_cast<int>(launch_reduce<float, float>(in, out, W, N, s));
  if (in_dtype == kF32 && out_dtype == kBF16)
    return static_cast<int>(launch_reduce<float, __nv_bfloat16>(in, out, W, N, s));
  if (in_dtype == kBF16 && out_dtype == kF32)
    return static_cast<int>(launch_reduce<__nv_bfloat16, float>(in, out, W, N, s));
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return static_cast<int>(launch_reduce<__nv_bfloat16, __nv_bfloat16>(in, out, W, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int chunk_reduce_pairs(void* buf, const int64_t* dst, const int64_t* src, int64_t P,
                                  int64_t C, int64_t dtype, void* stream) {
  if (P < 1 || P > 65535 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_pairs<float>(buf, dst, src, P, C, s));
  if (dtype == kBF16) return static_cast<int>(launch_pairs<__nv_bfloat16>(buf, dst, src, P, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
