// ln_geglu_fwd: LayerNorm of x (M, C) bf16, then [h | g] = x̂·W0ᵀ + b0 with
// W0 (2N, C) bf16 (PyTorch Linear layout) and b0 (2N,) fp32, then
// out = h · gelu(g) (exact erf GELU), out (M, N) bf16 with N = 4C.
//
// Replaces psd_tpu/ops/geglu.py::_kernel (entry ln_geglu): norm3 + the GEGLU
// projection of every UNet transformer feed-forward. The Pallas kernel uses
// the Abramowitz–Stegun erf polynomial (|err| ≤ 1.5e-7) because Mosaic has
// no erf; this one calls erff, and the parity band covers the difference.
//
// What bounds it on the H100. At stage 0 (M = 32768, C = 320, N = 1280) it is
// 2·M·C·2N ≈ 54 GFLOP against 21 MB of x in and 84 MB out: ≈500 FLOP per
// byte, compute-bound. Unfused, the (M, 2N) projection (335 MB in fp32 at
// stage 0) is written and read back for the bias and gate, and LayerNorm
// takes its own pass over x.
//
// Design: the LN-fused GEMM of ln_gemm.cuh. A block owns 64 output columns:
// its 128-row B tile holds the h rows n0..n0+63 and the g rows N+n0..N+n0+63
// of W0, and each warp's four column fragments pair two h fragments with the
// two g fragments of the same output columns. The epilogue adds the fp32
// biases and applies h·gelu(g) in fp32 from the warp's stage; the (M, N)
// bf16 output is the only write, and the (M, 2N) projection never leaves the
// SM. Requires M % 128 == 0, C % 32 == 0, N % 64 == 0 (the wrapper checks).
#include "ln_gemm.cuh"

namespace psd {
namespace {

using namespace lngemm;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__global__ void __launch_bounds__(kThreads)
ln_geglu_kernel(const bf16* __restrict__ x, const float* __restrict__ lw,
                const float* __restrict__ lb, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out, int C, int N,
                float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const int row0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * 64;

  const LnNorm norm = ln_stats(x, lw, lb, row0, C, eps, s);
  Acc acc[2][4];
  mainloop(
      x, w, row0, gridDim.x * kBM, C, norm, [=](int t) { return t < 64 ? n0 + t : N + n0 + (t - 64); },
      [](int wc, int j) { return j < 2 ? wc * 32 + j * 16 : 64 + wc * 32 + (j - 2) * 16; },
      s, acc);
  const float* st = stage_acc(s, acc);  // cols 0..31: h, 32..63: g

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int c = (lane % 16) * 2;
  const int col = n0 + wc * 32 + c;
  const float bh0 = bias[col], bh1 = bias[col + 1];
  const float bg0 = bias[N + col], bg1 = bias[N + col + 1];
  for (int r = lane / 16; r < 32; r += 2) {
    const float* sr = st + r * kLdStage;
    const float h0 = sr[c] + bh0, h1 = sr[c + 1] + bh1;
    const float g0 = sr[32 + c] + bg0, g1 = sr[32 + c + 1] + bg1;
    const __nv_bfloat162 v = __floats2bfloat162_rn(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0 + wr * 32 + r) * N + col) = v;
  }
}

}  // namespace
}  // namespace psd

extern "C" int psd_ln_geglu_fwd(const void* x, const void* ln_w, const void* ln_b,
                                const void* w, const void* b, void* out, int M, int C,
                                int N, float eps, void* stream) {
  using namespace psd;
  using namespace psd::lngemm;
  const size_t bytes = smem_bytes(C);
  cudaError_t err = allow_smem(ln_geglu_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M / kBM, N / 64);
  ln_geglu_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), C, N, eps);
  return static_cast<int>(cudaGetLastError());
}
