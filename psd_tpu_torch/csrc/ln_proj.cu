// ln_proj_fwd: LayerNorm of x (M, C) bf16, then 1 or 3 bias-free projections
// of the same normalized rows: o_i = x̂ · W_iᵀ, W_i (N, C) bf16 in PyTorch's
// Linear layout, fp32 accumulation, bf16 out.
//
// Replaces psd_tpu/ops/geglu.py::_mm_kernel (entry ln_proj): norm1 + to_q/k/v
// at the self-attention sites, norm2 + to_q at the cross-attention sites.
//
// What bounds it on the H100. At stage 0 (M = 32768, C = 320, three outputs)
// it is 2·M·C·3C ≈ 20 GFLOP against 21 MB of x in and 63 MB out: about 240
// FLOP per byte, just under the card's ≈295 balance point, so both the tensor
// cores and the output write matter; at C = 1280 (M = 2048) it is firmly
// compute-bound. Unfused, LayerNorm is its own read and write of x, and x̂
// is read once more per projection.
//
// Design: the LN-fused GEMM of ln_gemm.cuh (128 × 128 tiles, x normalized
// on its way into shared memory, W through cp.async, WMMA bf16). Each block
// takes one 128-column tile of one output; grid.y walks the tiles of all
// outputs, so x̂ is recomputed from x per column tile (x stays in L2) rather
// than written. N % 128 == 64 (C = 320, 640) leaves the last tile half
// empty: its W rows read as zeros and its missing half is not stored.
// Requires M % 128 == 0, C % 32 == 0, N % 64 == 0 (the wrapper checks).
#include "ln_gemm.cuh"

namespace psd {
namespace {

using namespace lngemm;

__global__ void __launch_bounds__(kThreads)
ln_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ lw,
               const float* __restrict__ lb, const bf16* w0, const bf16* w1,
               const bf16* w2, bf16* o0, bf16* o1, bf16* o2, int C, int N, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const int row0 = blockIdx.x * kBM;
  const int tiles_per_out = (N + kBN - 1) / kBN;
  const int which = blockIdx.y / tiles_per_out;
  const int n0 = (blockIdx.y % tiles_per_out) * kBN;
  const bf16* W = which == 0 ? w0 : (which == 1 ? w1 : w2);
  bf16* O = which == 0 ? o0 : (which == 1 ? o1 : o2);

  const LnNorm norm = ln_stats(x, lw, lb, row0, C, eps, s);
  Acc acc[2][4];
  mainloop(
      x, W, row0, gridDim.x * kBM, C, norm, [=](int t) { return n0 + t < N ? n0 + t : -1; },
      [](int wc, int j) { return wc * 64 + j * 16; }, s, acc);
  const float* st = stage_acc(s, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int col0 = n0 + wc * 64;
  if (col0 >= N) return;
  const int c = lane * 2;
  for (int r = 0; r < 32; ++r) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(st[r * kLdStage + c], st[r * kLdStage + c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(O + static_cast<size_t>(row0 + wr * 32 + r) * N + col0 + c) = v;
  }
}

}  // namespace
}  // namespace psd

extern "C" int psd_ln_proj_fwd(const void* x, const void* ln_w, const void* ln_b,
                               const void* w0, const void* w1, const void* w2, void* o0,
                               void* o1, void* o2, int n_out, int M, int C, int N,
                               float eps, void* stream) {
  using namespace psd;
  using namespace psd::lngemm;
  const size_t bytes = smem_bytes(C);
  cudaError_t err = allow_smem(ln_proj_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M / kBM, n_out * ((N + kBN - 1) / kBN));
  ln_proj_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), static_cast<bf16*>(o0),
      static_cast<bf16*>(o1), static_cast<bf16*>(o2), C, N, eps);
  return static_cast<int>(cudaGetLastError());
}
