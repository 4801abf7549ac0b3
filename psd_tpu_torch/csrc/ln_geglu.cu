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
// byte, compute-bound (0.054 ms at 989 TFLOP/s). Unfused, the (M, 2N)
// projection (335 MB in fp32 at stage 0) is written and read back for the
// bias and gate, and LayerNorm takes its own pass over x.
//
// Design: the LN-fused wgmma GEMM of ln_gemm_sm90.cuh (stats pass, TMA
// ring, A normalized in registers). A tile is 128 rows × 128 output
// columns: its B tile stacks W0's h rows n0..n0+127 over its g rows
// N+n0..N+n0+127 (two TMA boxes from two maps of W0's halves, so a ragged
// last tile reads zeros in each half), one m64n256k16 per k16 step. In the
// accumulator layout output column 8j + 2·tig (+1) of h and of g sit in the
// same thread (acc[4j + e] and acc[4(j + 16) + e]), so the fp32 biases and
// h·gelu(g) are applied in registers; the bf16 result goes through shared
// memory to TMA stores, and the (M, N) output is the only write: the
// (M, 2N) projection never leaves the SM.
#include "ln_gemm_sm90.cuh"

namespace psd {
namespace {

using namespace lnsm90;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

struct GegluEpi {
  static constexpr int kOutputs = 1;
  const float* bias;  // (2N,): h's, then g's
  int N;

  __host__ __device__ static constexpr int out_map(int) { return 0; }
  // a tile's output columns ct·128 .. +127: two 64-column boxes
  __device__ static int out_col(int ct, int b) { return ct * 128 + 64 * b; }

  // Output column block jb (columns ct·128 + 8jb + 2·tig (+1)) of rows g and
  // g + 8 as packed bf16: h from acc[4jb + e], g from acc[4(jb + 16) + e].
  __device__ __forceinline__ void pack(const float (&acc)[128], int jb, int ct, int tig,
                                       uint32_t& lo, uint32_t& hi) const {
    const int col = ct * 128 + 8 * jb + 2 * tig;
    float2 bh = make_float2(0.f, 0.f), bg = bh;  // columns past N are not stored
    if (col < N) {
      bh = __ldg(reinterpret_cast<const float2*>(bias + col));
      bg = __ldg(reinterpret_cast<const float2*>(bias + N + col));
    }
    const int h = 4 * jb, g = 4 * (jb + 16);
    lo = pack_bf16x2((acc[h] + bh.x) * gelu_erf(acc[g] + bg.x),
                     (acc[h + 1] + bh.y) * gelu_erf(acc[g + 1] + bg.y));
    hi = pack_bf16x2((acc[h + 2] + bh.x) * gelu_erf(acc[g + 2] + bg.x),
                     (acc[h + 3] + bh.y) * gelu_erf(acc[g + 3] + bg.y));
  }
};

}  // namespace
}  // namespace psd

extern "C" int psd_ln_geglu_fwd(const void* x, const void* ln_w, const void* ln_b,
                                const void* w, const void* b, void* out, void* stats, int M,
                                int C, int N, float eps, void* stream) {
  using namespace psd;
  using namespace psd::lnsm90;
  const bf16* w0 = static_cast<const bf16*>(w);
  const bf16* const halves[3] = {w0, w0 + static_cast<size_t>(N) * C, nullptr};
  bf16* const outs[3] = {static_cast<bf16*>(out), nullptr, nullptr};
  const GegluEpi epi{static_cast<const float*>(b), N};
  return static_cast<int>(launch<Kind::kGeglu>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), halves, outs, epi, static_cast<float2*>(stats), M, C, N,
      eps, static_cast<cudaStream_t>(stream)));
}
