// The rate of mma.sync.m16n8k8 TF32 (fp32 accumulate) on one card, with no
// memory traffic: each warp runs CHAINS independent accumulators through
// `iters` rounds of one MMA each. The general flash-attention route
// (src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu) issues
// these MMAs; tools/flash_attention_variants.py times this kernel beside it
// to show the ceiling of that instruction (the 495 TFLOP/s TF32 peak of the
// data sheet is wgmma's).
//
// Plain C interface (ctypes): mma_tf32_peak(out, blocks, warps, iters, stream)
// launches blocks x (32 warps) threads and returns the cudaError_t of the
// launch; out receives one float per thread so nothing is optimised away.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

__global__ void mma_tf32_loop(float* out, int iters) {
  const uint32_t t = threadIdx.x;
  uint32_t a[4] = {0x3f800000u ^ (t << 13), 0x3f000000u ^ (t << 13), 0x3e800000u, 0x3f800000u};
  const uint32_t b0 = 0x3f800000u ^ (t << 13), b1 = 0x3c000000u;
  float c[kChains][4];
#pragma unroll
  for (int i = 0; i < kChains; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + t] = s;
}

}  // namespace

// flops of one launch: blocks * warps * iters * kChains * 2 * 16 * 8 * 8
extern "C" int mma_tf32_peak(void* out, int blocks, int warps, int iters, void* stream) {
  mma_tf32_loop<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_tf32_chains() { return kChains; }
