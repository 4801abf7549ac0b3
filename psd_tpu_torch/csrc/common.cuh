// Shared helpers for the psd_tpu_torch kernels (sm_90a, bf16 operands,
// fp32 accumulation). Each kernel file exports one extern "C" launcher that
// returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace psd {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise a kernel's dynamic shared memory limit when it needs more than the
// 48 KB default (opt-in up to 227 KB on Hopper).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// mma.sync m16n8k16, bf16 operands, fp32 accumulate, in place: d += a·b.
// Fragment layouts (PTX ISA): lane = 4·g + tig; A holds rows g and g+8 at
// columns 2·tig(+1) and 2·tig+8(+1); B holds k = 2·tig(+1) and 2·tig+8(+1)
// at column g; C/D holds rows g and g+8 at columns 2·tig(+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed into one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack_bf16x2, and add the two rounded values to `sum` (an attention
// denominator sums exactly the probabilities that enter P·V).
__device__ __forceinline__ uint32_t pack_bf16x2_sum(float lo, float hi, float& sum) {
  const uint32_t r = pack_bf16x2(lo, hi);
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  sum += __low2float(v) + __high2float(v);
  return r;
}

}  // namespace psd
