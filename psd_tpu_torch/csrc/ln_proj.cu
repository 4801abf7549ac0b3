// ln_proj_fwd: LayerNorm of x (M, C) bf16, then 1 or 3 bias-free projections
// of the same normalized rows: o_i = x̂ · W_iᵀ, W_i (N, C) bf16 in PyTorch's
// Linear layout, fp32 accumulation, bf16 out.
//
// Replaces psd_tpu/ops/geglu.py::_mm_kernel (entry ln_proj): norm1 + to_q/k/v
// at the self-attention sites, norm2 + to_q at the cross-attention sites.
//
// What bounds it on the H100. At stage 0 (M = 32768, C = 320, three outputs)
// it is 2·M·C·3C ≈ 20 GFLOP against 21 MB of x in and 63 MB out: about 240
// FLOP per byte, just under the card's ≈295 balance point, so the output
// write sets the bound (0.025 ms); at C = 640 and 1280 it is compute-bound.
// Unfused, LayerNorm is its own read and write of x, and x̂ is read once
// more per projection.
//
// Design: the LN-fused wgmma GEMM of ln_gemm_sm90.cuh (stats pass, TMA
// ring, A normalized in registers). With three outputs a tile's B stacks 64
// rows of each of W_q, W_k and W_v (three TMA boxes, m64n192k16), so each
// normalized A fragment feeds all three outputs and x is normalized once
// for q, k and v; every C % 64 == 0 splits into whole 64-column slices, so
// C = 320 has no half-empty tile. Each output's 64 columns leave through
// shared memory by TMA store. With one output the tile is 160 columns
// (m64n160k16; 160 divides 320, 640 and 1280), stored from registers;
// elsewhere TMA's zero fill covers the ragged last tile and its missing
// columns are not stored.
#include "ln_gemm_sm90.cuh"

namespace psd {
namespace {

using namespace lnsm90;

// Three outputs: accumulator column block jb (columns 8jb + 2·tig (+1)) is
// output jb / 8's columns ct·64 + 8(jb % 8) + 2·tig (+1); each output's 64
// columns are one box, stored by TMA.
struct Proj3Epi {
  static constexpr int kOutputs = 3;

  __host__ __device__ static constexpr int out_map(int b) { return b; }
  __device__ static int out_col(int ct, int) { return ct * 64; }

  __device__ __forceinline__ void pack(const float (&acc)[96], int jb, int, int, uint32_t& lo,
                                       uint32_t& hi) const {
    lo = pack_bf16x2(acc[4 * jb], acc[4 * jb + 1]);
    hi = pack_bf16x2(acc[4 * jb + 2], acc[4 * jb + 3]);
  }
};

// One output: rows `row` and row + 8 of columns ct·160 + 8j + 2·tig (+1),
// stored from registers (columns past N are not stored).
struct Proj1Epi {
  static constexpr int kOutputs = 1;
  bf16* out;
  int N;

  __device__ __forceinline__ void store(const float (&acc)[80], int row, int ct, int tig) const {
#pragma unroll
    for (int j = 0; j < 20; ++j) {
      const int col = ct * 160 + 8 * j + 2 * tig;
      if (col < N) {
        bf16* r0 = out + static_cast<size_t>(row) * N + col;
        *reinterpret_cast<uint32_t*>(r0) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(r0 + 8 * static_cast<size_t>(N)) =
            pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
};

}  // namespace
}  // namespace psd

extern "C" int psd_ln_proj_fwd(const void* x, const void* ln_w, const void* ln_b,
                               const void* w0, const void* w1, const void* w2, void* o0,
                               void* o1, void* o2, void* stats, int n_out, int M, int C, int N,
                               float eps, void* stream) {
  using namespace psd;
  using namespace psd::lnsm90;
  const bf16* const w[3] = {static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                            static_cast<const bf16*>(w2)};
  bf16* const o[3] = {static_cast<bf16*>(o0), static_cast<bf16*>(o1), static_cast<bf16*>(o2)};
  const bf16* xp = static_cast<const bf16*>(x);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  float2* sp = static_cast<float2*>(stats);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_out == 3)
    return static_cast<int>(
        launch<Kind::kProj3>(xp, lw, lb, w, o, Proj3Epi{}, sp, M, C, N, eps, st));
  if (n_out == 1)
    return static_cast<int>(
        launch<Kind::kProj1>(xp, lw, lb, w, o, Proj1Epi{o[0], N}, sp, M, C, N, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
