// gn_proj_fwd: a GroupNorm folded into a per-(batch, channel) affine, fused
// into the projection that follows it:
//   out[b, s, :] = bf16( bf16(x[b, s, :]·w[b, :] + b[b, :]) · Wᵀ + bias )
// x (B, S, C) bf16, w/b (B, C) fp32 (from group_norm_fold), W (N, C) bf16 in
// PyTorch's Linear layout, bias (N,) fp32, fp32 accumulation, bf16 out.
//
// Replaces psd_tpu/ops/gnproj.py::_kernel (the Transformer2D's GroupNorm →
// proj_in). The GroupNorm statistics span the whole (S, C/G) plane, so they
// are computed beforehand as the (B, C) affine (ops/norms.py, plain torch);
// this kernel applies it on the way into the GEMM so the normalized tensor
// never touches device memory.
//
// What bounds it on the H100. At stage 0 (B·S = 32768, C = N = 320) it is
// 2·M·C·N ≈ 6.7 GFLOP against 21 MB of x in and 21 MB out: ≈160 FLOP per
// byte, under the card's ≈295 balance point, so memory-bound; at C = 640
// and 1280 (M = 8192, 2048) compute-bound. Unfused, the affine is its own
// read and write of x.
//
// Design: the normalization-fused GEMM of ln_gemm.cuh (128 × 128 tiles, x
// transformed on its way into shared memory, W through cp.async, WMMA bf16)
// with GnNorm as the transform. A 128-row tile covers at most two batch
// elements (S % 64 == 0, so S ≥ 64; at the mid block S = 64): the prologue
// stages both batches' affines and a batch slot per row (row / S), and each
// element looks its affine up by its row's slot, never once per tile. The
// last tile may be half full (B·S % 128 == 64): its missing rows read as 0
// and are not stored. N % 128 == 64 (C = 320; 640 = 5·128) leaves the
// last column tile half empty. Requires S % 64 == 0, C % 32 == 0,
// N % 64 == 0 (the wrapper checks).
#include "ln_gemm.cuh"

namespace psd {
namespace {

using namespace lngemm;

__global__ void __launch_bounds__(kThreads)
gn_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ gw,
               const float* __restrict__ gb, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int B, int S, int C,
               int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const int M = B * S;
  const int row0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // prologue: batch slot per row, and the affines of the (at most two)
  // batch elements the tile covers
  const int b0 = row0 / S;
  int* slot = reinterpret_cast<int*>(s.row0);
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int bb = min((row0 + r) / S, B - 1);
    slot[r] = bb - b0;
  }
  float* sw = s.vec;
  float* sb = s.vec + 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    const int bb = min(b0 + i / C, B - 1);
    const int c = i % C;
    sw[i] = gw[static_cast<size_t>(bb) * C + c];
    sb[i] = gb[static_cast<size_t>(bb) * C + c];
  }
  __syncthreads();
  const GnNorm norm{slot, sw, sb, C};

  Acc acc[2][4];
  mainloop(
      x, w, row0, M, C, norm, [=](int t) { return n0 + t < N ? n0 + t : -1; },
      [](int wc, int j) { return wc * 64 + j * 16; }, s, acc);
  const float* st = stage_acc(s, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int col0 = n0 + wc * 64;
  if (col0 >= N) return;
  const int c = lane * 2;
  const float bias0 = bias[col0 + c], bias1 = bias[col0 + c + 1];
  for (int r = 0; r < 32; ++r) {
    const int row = row0 + wr * 32 + r;
    if (row >= M) break;
    const __nv_bfloat162 v = __floats2bfloat162_rn(st[r * kLdStage + c] + bias0,
                                                   st[r * kLdStage + c + 1] + bias1);
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N + col0 + c) = v;
  }
}

}  // namespace
}  // namespace psd

extern "C" int psd_gn_proj_fwd(const void* x, const void* gw, const void* gb, const void* w,
                               const void* bias, void* out, int B, int S, int C, int N,
                               void* stream) {
  using namespace psd;
  using namespace psd::lngemm;
  const size_t bytes = smem_bytes(C, 4);
  cudaError_t err = allow_smem(gn_proj_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * S;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  gn_proj_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gw),
      static_cast<const float*>(gb), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, S, C, N);
  return static_cast<int>(cudaGetLastError());
}
