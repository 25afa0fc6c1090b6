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
// operations per byte where the card would be compute-bound. Every input byte
// is read once and every output byte written once.
//
// W-way form: a grid-stride loop over 16-byte vectors (4 fp32 or 8 bf16 per
// thread), neighbouring threads on neighbouring addresses, the W-way sum kept
// in registers. A row whose length or base address does not allow 16-byte
// vectors takes the scalar instance of the same template (VEC = 1).
//
// Pair form: a stream of tiles. The pairs' rows are cut into tiles of
// tile_bytes; tile t is pair t / tiles_per_pair at element offset
// (t % tiles_per_pair) * tile_elems (the formula of pairs_tile in kernel.py).
// One CTA per 32 KB tile (one-shot, not persistent): its 16-byte aligned
// body is 256 threads x 8 vectors, and every thread loads its eight dst and
// eight src vectors (ld.global.cs: read once) before it stores any
// (st.global.cs), so a CTA keeps 64 KB of loads in flight. The elements
// before and after the body (a row or view that starts off 16-byte
// alignment, fp32 rows with C % 4 != 0, bf16 rows with C % 8 != 0) are added
// with scalar loads and stores by the same CTA in the same launch; a tile
// whose dst and src sit at different offsets within 16 bytes is all edge.
// Measured at the training path's shape (tools/chunk_reduce_pairs_variants.py)
// this reaches ~91-92 % of the byte bound, as PyTorch's add_ does; a ring of
// bulk copies (cp.async.bulk into shared memory, mbarriers) walked by
// persistent CTAs, and the grid-stride loop this replaced, stopped at
// ~86-87 %. That ring is kept for the measurement in
// tools/chunk_reduce_pairs_ring.cu, which includes this file and uses its
// Tile, tile_at, add16, add_edges, kThreads, sm_count and DType.
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
constexpr int kVecs = 8;         // pair form: 16-byte vectors per thread and operand
constexpr int64_t kTileBytes = 16 * kThreads * kVecs;  // pair form: one CTA's tile

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

// ---------------------------------------------------------------------------
// pair form
// ---------------------------------------------------------------------------

// One tile of one pair: dst and src point at its first element; head, body
// and tail count elements (body a whole number of 16-byte vectors, 16-byte
// aligned on both sides).
template <typename T>
struct Tile {
  T* dst;
  const T* src;
  int64_t head, body, tail;
};

template <typename T>
__device__ __forceinline__ Tile<T> tile_at(T* buf, const int64_t* __restrict__ dst,
                                           const int64_t* __restrict__ src, int64_t C,
                                           int64_t tile_elems, int64_t t) {
  const int64_t per_pair = (C + tile_elems - 1) / tile_elems;
  const int64_t j = t / per_pair;
  const int64_t off = (t - j * per_pair) * tile_elems;
  const int64_t len = C - off < tile_elems ? C - off : tile_elems;
  Tile<T> tl;
  tl.dst = buf + dst[j] * C + off;
  tl.src = buf + src[j] * C + off;
  const int64_t md = static_cast<int64_t>(reinterpret_cast<uintptr_t>(tl.dst) % 16);
  const int64_t ms = static_cast<int64_t>(reinterpret_cast<uintptr_t>(tl.src) % 16);
  if (md != ms) {
    tl.head = len;
    tl.body = 0;
  } else {
    const int64_t h = ((16 - md) % 16) / static_cast<int64_t>(sizeof(T));
    tl.head = h < len ? h : len;
    constexpr int64_t kVec = 16 / sizeof(T);
    tl.body = (len - tl.head) / kVec * kVec;
  }
  tl.tail = len - tl.head - tl.body;
  return tl;
}

// 16-byte vector add with one rounding per element, on the raw bits.
template <typename T>
__device__ __forceinline__ float4 add16(float4 a, float4 b) {
  constexpr int VEC = 16 / sizeof(T);
  const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(&a);
  const Vec<T, VEC> y = *reinterpret_cast<const Vec<T, VEC>*>(&b);
  Vec<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(to_f32(x.v[k]) + to_f32(y.v[k]));
  return *reinterpret_cast<const float4*>(&o);
}

// The head and tail of a tile, one element per thread and step.
template <typename T>
__device__ __forceinline__ void add_edges(const Tile<T>& tl) {
  const int64_t n = tl.head + tl.tail;
  for (int64_t e = threadIdx.x; e < n; e += blockDim.x) {
    const int64_t i = e < tl.head ? e : e + tl.body;
    tl.dst[i] = from_f32<T>(to_f32(__ldcs(tl.dst + i)) + to_f32(__ldcs(tl.src + i)));
  }
}

// One CTA per tile of kThreads * kVecs vectors; every thread loads its
// vectors of both rows before it stores any. The caller guarantees that no
// row is both a source and a destination and that no destination repeats, so
// no two tiles touch the same element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_pairs_kernel(T* buf, const int64_t* __restrict__ dst,
                          const int64_t* __restrict__ src, int64_t C) {
  const Tile<T> tl =
      tile_at(buf, dst, src, C, kTileBytes / static_cast<int64_t>(sizeof(T)), blockIdx.x);
  const float4* __restrict__ d = reinterpret_cast<const float4*>(tl.dst + tl.head);
  const float4* __restrict__ r = reinterpret_cast<const float4*>(tl.src + tl.head);
  float4* out = reinterpret_cast<float4*>(tl.dst + tl.head);
  const int64_t nvec = tl.body * static_cast<int64_t>(sizeof(T)) / 16;
  float4 a[kVecs], b[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int64_t i = threadIdx.x + u * kThreads;
    if (i < nvec) {
      a[u] = __ldcs(d + i);
      b[u] = __ldcs(r + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int64_t i = threadIdx.x + u * kThreads;
    if (i < nvec) __stcs(out + i, add16<T>(a[u], b[u]));
  }
  add_edges(tl);
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

// One CTA per tile; tiles and their count follow kernel.py::pairs_tile.
template <typename T>
cudaError_t launch_pairs(void* buf, const int64_t* dst, const int64_t* src, int64_t P, int64_t C,
                         cudaStream_t stream) {
  constexpr int64_t tile_elems = kTileBytes / static_cast<int64_t>(sizeof(T));
  const int64_t tiles = P * ((C + tile_elems - 1) / tile_elems);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  chunk_reduce_pairs_kernel<T><<<static_cast<unsigned int>(tiles), kThreads, 0, stream>>>(
      static_cast<T*>(buf), dst, src, C);
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
  if (P < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_pairs<float>(buf, dst, src, P, C, s));
  if (dtype == kBF16) return static_cast<int>(launch_pairs<__nv_bfloat16>(buf, dst, src, P, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
