// A design of chunk_reduce's pair form that the port measured and did not
// keep: a ring of bulk copies walked by persistent CTAs. It is built only by
// tools/chunk_reduce_pairs_variants.py, which times it against the port's
// kernel (src/repro_torch/kernels/chunk_reduce/csrc/chunk_reduce.cu, whose
// helpers and tile schedule it includes) at the training path's shape.
//
// Each tile's 16-byte aligned body goes by bulk copy (cp.async.bulk,
// completion on an mbarrier, L2 evict-first) into a ring of `stages`
// shared-memory stages of one dst and one src tile each; persistent CTAs
// (ctas_per_sm per SM) walk the tiles t = blockIdx.x, + gridDim.x, ..., so a
// CTA has stages - 1 tiles in flight while it adds one. The add runs on
// 16-byte shared reads and writes back with 16-byte streaming stores; thread
// 0 refills a stage only after the CTA's barrier says every thread has read
// it. Heads and tails go through the same scalar path as the port's kernel.
// It is bit-equal to the plain version, and at the training shape it reached
// ~86-87 % of the byte bound against the port's ~91-92 %.

#include "../src/repro_torch/kernels/chunk_reduce/csrc/chunk_reduce.cu"

namespace {

constexpr int kMaxStages = 4;
// 227 KB a CTA may use, less 1 KB for the kernel's static barriers
constexpr int64_t kMaxSmem = 232448 - 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Persistent CTAs over a ring of bulk-copied stages.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_pairs_bulk(T* buf, const int64_t* __restrict__ dst,
                        const int64_t* __restrict__ src, int64_t C, int64_t tiles,
                        int64_t tile_elems, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_elems * sizeof(T));
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t mine = first < tiles ? (tiles - first + step - 1) / step : 0;

  uint64_t policy = 0;
  if (threadIdx.x == 0) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: start the bulk copies of the k-th tile of this CTA
  auto issue = [&](int64_t k) {
    const Tile<T> tl = tile_at(buf, dst, src, C, tile_elems, first + k * step);
    if (tl.body == 0) return;
    const int s = static_cast<int>(k % stages);
    unsigned char* d = ring + 2 * static_cast<size_t>(s) * tile_bytes;
    const uint32_t bytes = static_cast<uint32_t>(tl.body * sizeof(T));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(&full[s])),
                 "r"(2 * bytes)
                 : "memory");
    bulk_load(d, tl.dst + tl.head, bytes, &full[s], policy);
    bulk_load(d + tile_bytes, tl.src + tl.head, bytes, &full[s], policy);
  };

  if (threadIdx.x == 0)
    for (int64_t k = 0; k < stages && k < mine; ++k) issue(k);

  uint32_t parity = 0;  // bit s: parity of stage s's next completion
  for (int64_t k = 0; k < mine; ++k) {
    const Tile<T> tl = tile_at(buf, dst, src, C, tile_elems, first + k * step);
    const int s = static_cast<int>(k % stages);
    if (tl.body > 0) {
      mbar_wait(&full[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      const float4* d = reinterpret_cast<const float4*>(ring + 2 * static_cast<size_t>(s) * tile_bytes);
      const float4* r = reinterpret_cast<const float4*>(ring + (2 * static_cast<size_t>(s) + 1) * tile_bytes);
      float4* out = reinterpret_cast<float4*>(tl.dst + tl.head);
      const int64_t nvec = tl.body * static_cast<int64_t>(sizeof(T)) / 16;
      for (int64_t i = threadIdx.x; i < nvec; i += kThreads) __stcs(out + i, add16<T>(d[i], r[i]));
    }
    add_edges(tl);
    __syncthreads();  // every thread is done reading stage s
    if (threadIdx.x == 0 && k + stages < mine) {
      // order the generic-proxy reads of stage s before the async-proxy refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + stages);
    }
  }
}

template <typename T>
cudaError_t launch_ring(void* buf, const int64_t* dst, const int64_t* src, int64_t P, int64_t C,
                        int64_t tile_bytes, int64_t stages, int64_t ctas_per_sm,
                        cudaStream_t stream) {
  const int64_t tile_elems = tile_bytes / static_cast<int64_t>(sizeof(T));
  const int64_t tiles = P * ((C + tile_elems - 1) / tile_elems);
  const int64_t smem = 2 * stages * tile_bytes;
  if (stages < 2 || stages > kMaxStages || smem > kMaxSmem || ctas_per_sm < 1)
    return cudaErrorInvalidValue;
  static int64_t smem_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_reduce_pairs_bulk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  int64_t grid = ctas_per_sm * sm_count();
  if (grid > tiles) grid = tiles;
  chunk_reduce_pairs_bulk<T><<<static_cast<unsigned int>(grid), kThreads, smem, stream>>>(
      static_cast<T*>(buf), dst, src, C, tiles, tile_elems, static_cast<int>(stages));
  return cudaGetLastError();
}

}  // namespace

// The pair form's contract (buf[dst_j] += buf[src_j]) on the ring: tile_bytes
// a multiple of 16, 2 * stages * tile_bytes of shared memory per CTA,
// ctas_per_sm * SMs persistent CTAs.
extern "C" int chunk_reduce_pairs_ring(void* buf, const int64_t* dst, const int64_t* src,
                                       int64_t P, int64_t C, int64_t dtype, int64_t tile_bytes,
                                       int64_t stages, int64_t ctas_per_sm, void* stream) {
  if (P < 1 || C < 1 || tile_bytes < 16 || tile_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        launch_ring<float>(buf, dst, src, P, C, tile_bytes, stages, ctas_per_sm, s));
  if (dtype == kBF16)
    return static_cast<int>(
        launch_ring<__nv_bfloat16>(buf, dst, src, P, C, tile_bytes, stages, ctas_per_sm, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
