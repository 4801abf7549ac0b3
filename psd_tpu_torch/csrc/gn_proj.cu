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
// Design: Kind::kGn of the normalization-fused wgmma GEMM of
// ln_gemm_sm90.cuh (no stats pass; persistent, TMA ring, x transformed in
// the A registers). Each stage brings the K chunk's w and b of both batch
// elements a 128-row tile can cover (S % 64 == 0, so S ≥ 64: at the mid
// block S = 64 every tile straddles two), and each row picks its own by
// its batch slot. B is a 192-row slice of W (m64n192); the epilogue adds
// the fp32 bias and the bf16 tile leaves through shared memory by TMA
// stores under the next tile's products (stores from registers of
// 160-column tiles measured 17–81% slower on an H100,
// scripts/torch_ln_gemm_variants.py gn_register_store). A half-full last
// row tile (B·S % 128 == 64: B odd, S % 128 == 64) reads zeros past M
// through TMA and its stores write none of its missing rows. Requires
// S % 64 == 0, C % 64 == 0, N % 8 == 0 (ops/gnproj.py::gn_shape_error).
#include "ln_gemm_sm90.cuh"

namespace psd {
namespace {

using namespace lnsm90;

// Output column block jb (columns ct·192 + 8jb + 2·tig (+1)) of rows g and
// g + 8 as packed bf16, with the fp32 bias; a tile's 192 columns are three
// 64-column boxes, stored by TMA (columns past N and rows past M are not
// written).
struct GnEpi {
  static constexpr int kOutputs = 1;
  const float* bias;
  int N;

  __host__ __device__ static constexpr int out_map(int) { return 0; }
  __device__ static int out_col(int ct, int b) { return ct * 192 + 64 * b; }

  __device__ __forceinline__ void pack(const float (&acc)[96], int jb, int ct, int tig,
                                       uint32_t& lo, uint32_t& hi) const {
    const int col = ct * 192 + 8 * jb + 2 * tig;
    const float2 bb =
        col < N ? __ldg(reinterpret_cast<const float2*>(bias + col)) : make_float2(0.f, 0.f);
    lo = pack_bf16x2(acc[4 * jb] + bb.x, acc[4 * jb + 1] + bb.y);
    hi = pack_bf16x2(acc[4 * jb + 2] + bb.x, acc[4 * jb + 3] + bb.y);
  }
};

}  // namespace
}  // namespace psd

extern "C" int psd_gn_proj_fwd(const void* x, const void* gw, const void* gb, const void* w,
                               const void* bias, void* out, int B, int S, int C, int N,
                               void* stream) {
  using namespace psd;
  using namespace psd::lnsm90;
  const bf16* const ws[3] = {static_cast<const bf16*>(w), nullptr, nullptr};
  bf16* const outs[3] = {static_cast<bf16*>(out), nullptr, nullptr};
  const int M = B * S;
  const GnEpi epi{static_cast<const float*>(bias), N};
  return static_cast<int>(launch<Kind::kGn>(
      static_cast<const bf16*>(x), static_cast<const float*>(gw), static_cast<const float*>(gb),
      ws, outs, epi, nullptr, M, C, N, 0.f, static_cast<cudaStream_t>(stream), S));
}
