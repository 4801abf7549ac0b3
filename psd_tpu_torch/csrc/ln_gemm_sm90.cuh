// A normalization fused into the A operand of a bf16 GEMM on Hopper: the
// kernels of ln_proj_fwd (ln_proj.cu), ln_geglu_fwd (ln_geglu.cu) and
// gn_proj_fwd (gn_proj.cu).
//
//   out tile = epilogue( bf16(norm(x))[rows] · Wᵀ[tile columns] ),
//   x (M, C) bf16, W (·, C) bf16 in PyTorch's Linear layout, fp32 sums
//
// The LayerNorm kinds take flax's: per-row μ and rstd = rsqrt(max(E[x²] −
// μ², 0) + eps) in fp32, then (x − μ)·rstd·lw + lb in fp32, rounded to bf16
// before the product, as psd_tpu/ops/geglu.py's kernels do. Kind::kGn takes
// a GroupNorm folded into a per-(batch, channel) affine: x·w[b] + b[b] in
// fp32 (a product, then a sum, as psd_tpu/ops/gnproj.py and the plain
// version round them), rounded to bf16; x is (B·S, C) and row r belongs to
// batch element r / S.
//
// Two launches on the caller's stream for the LayerNorm kinds, the second
// alone for Kind::kGn:
//  1. ln_stats_kernel: one warp a row reads x once and writes (μ, rstd) as
//     fp32 (M, 2) into scratch the wrapper allocates, so the GEMM's column
//     tiles share one reading of each row's statistics. Computed instead in
//     each tile's prologue (every column tile reading its 128 rows of x
//     again, no second launch), the GEMM measured 5–40% slower at
//     chip_smoke.py's LN_SHAPES on an H100 (scripts/torch_ln_gemm_variants.py
//     stats_in_block); the pass itself takes 0.003–0.009 ms.
//  2. ln_gemm_kernel<Kind, Epi>: persistent, one block of 384 threads an
//     SM walking (128-row, column) tiles, the column tile fastest (a block
//     a tile measured up to 40% slower at C = 320).
//     * The producer warpgroup (setmaxnreg 24; one thread issues) fills a
//       ring of kStages stages through TMA, each completed on its full
//       mbarrier: the x box (64 columns × 128 rows, 16 KB), the B tile
//       (kSlices boxes of 64 columns × kSliceRows W rows, stacked: up to
//       three weights, or W0's h and g halves), and that K chunk's 64
//       values of lw and of lb by bulk copy (Kind::kGn: of w and of b for
//       each of the two batch elements a 128-row tile can cover, since
//       S ≥ 64). All boxes are 128-byte swizzled; rows and columns past
//       the tensors read as zeros.
//     * Two consumer warpgroups (setmaxnreg 240) own 64 rows each. For
//       each k16 step a thread ldmatrix-es its raw x fragment from the
//       swizzled stage (the mma.m16n8k16 A layout: rows g and g + 8,
//       columns 2·tig (+1) and 2·tig + 8 (+1)), normalizes the eight
//       values in fp32 with its two rows' μ, rstd (registers, from the
//       stats pass) and the columns' lw, lb (the stage; Kind::kGn: each
//       row's batch slot, row / S − the tile's first row / S, picks its
//       w, b from the stage), rounds them to
//       bf16 and packs the A register fragment; `wgmma` m64n{kBN}k16 then
//       takes A from registers and the B tile from shared memory, K-major.
//       x̂ never touches shared or device memory. Each warp releases the
//       stage on its empty mbarrier once its products have completed. (A
//       second A buffer, chunk k + 1 normalized while chunk k's products
//       run, measured 0–2% slower: the two warpgroups already cover each
//       other's normalization.)
//     * The epilogue takes the fp32 accumulators from registers (m64nN
//       layout: thread 4·g + tig of warp w holds rows 16w + g and + 8 at
//       columns 8j + 2·tig (+1)) while the producer loads the next tile's
//       chunks. With kOutBoxes > 0 (ln_geglu, ln_proj's three outputs),
//       Epi::pack gives bf16 pairs that stmatrix writes into 128-byte
//       swizzled 64 × 64 boxes, and TMA stores them while the next tile's
//       products run: stores straight from registers measured 14–70% slower
//       for ln_proj's three outputs and 2–4% for ln_geglu
//       (scripts/torch_ln_gemm_variants.py direct_store), and 17–81% for
//       gn_proj (gn_register_store). With ln_proj's one output, Epi::store
//       writes from registers (a 160-column tile is no whole number of
//       64-column boxes).
// Traits<Kind> fix the B tile: ln_geglu stacks 128 h rows over 128 g rows
// (m64n256), ln_proj with three outputs 64 rows of each weight (m64n192:
// one normalized A fragment feeds q, k and v), ln_proj with one output 160
// rows (m64n160; 160 divides 320, 640 and 1280); gn_proj 192 rows (m64n192,
// three output boxes; its epilogue adds the fp32 bias; N = 320 and 640 leave
// the last column tile ⅔ full). The LayerNorm kinds require M % 128 == 0,
// C % 64 == 0, N % 8 == 0 (ops/geglu.py::ln_shape_error); a ragged last
// column tile reads zero W rows and its missing columns are not stored.
// Kind::kGn requires S % 64 == 0 and M % S == 0 instead of M % 128 == 0
// (ops/gnproj.py::gn_shape_error): where B·S % 128 == 64 the last row
// tile's missing 64 rows read as zeros through TMA, and its stores write
// none of them.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace lnsm90 {
namespace {

using namespace hopper;

constexpr int kBM = 128;        // rows a tile: 64 for each consumer warpgroup
constexpr int kBK = 64;         // K a stage: one 128-byte box of bf16
constexpr int kThreads = 384;   // two consumer warpgroups, then the producer's
constexpr uint32_t kXBytes = kBM * 128;
constexpr size_t kSmemMax = 232448;  // the one block an SM

enum class Kind { kProj1, kProj3, kGeglu, kGn };

template <Kind K>
struct Shape;
// kOutBoxes: 64-column output boxes a consumer warpgroup stages in shared
// memory for TMA stores (0: the epilogue stores from registers).
template <>
struct Shape<Kind::kGeglu> {
  static constexpr int kSlices = 2, kSliceRows = 128, kStages = 3, kOutBoxes = 2;
};
template <>
struct Shape<Kind::kProj3> {
  static constexpr int kSlices = 3, kSliceRows = 64, kStages = 4, kOutBoxes = 3;
};
template <>
struct Shape<Kind::kProj1> {
  static constexpr int kSlices = 1, kSliceRows = 160, kStages = 6, kOutBoxes = 0;
};
template <>
struct Shape<Kind::kGn> {
  static constexpr int kSlices = 1, kSliceRows = 192, kStages = 4, kOutBoxes = 3;
};

// Shared memory: the stages' x and B tiles (1024-aligned), the two
// consumer warpgroups' output boxes (64 rows × 64 columns, 128-byte
// swizzled), then each stage's lw/lb chunk (Kind::kGn: w, b of batch slot
// 0, then of slot 1), then the full and empty mbarriers.
template <Kind K>
struct Traits : Shape<K> {
  using Shape<K>::kSlices;
  using Shape<K>::kSliceRows;
  using Shape<K>::kStages;
  using Shape<K>::kOutBoxes;
  static constexpr int kBN = kSlices * kSliceRows;  // wgmma's N
  static constexpr uint32_t kBBytes = kBN * 128;
  static constexpr uint32_t kTileBytes = kXBytes + kBBytes;
  static constexpr uint32_t kVecBytes = (K == Kind::kGn ? 4 : 2) * kBK * 4;
  static constexpr uint32_t kStageBytes = kTileBytes + kVecBytes;  // what TMA delivers
  static constexpr uint32_t kOutBytes = kOutBoxes * 64 * 128;      // a warpgroup's boxes
  static constexpr uint32_t kOffOut = kStages * kTileBytes;
  static constexpr uint32_t kOffVec = kOffOut + 2 * kOutBytes;
  static constexpr uint32_t kOffBar = kOffVec + kStages * kVecBytes;
  static constexpr size_t kSmemBytes = kOffBar + 16 * kStages + 1024;
  static_assert(kBN % 16 == 0 && kBN <= 256 && kSliceRows <= 256, "wgmma N and TMA box");
  static_assert(kOutBoxes == 0 || kOutBoxes * 64 == kBN / (K == Kind::kGeglu ? 2 : 1),
                "the output boxes cover the tile's output columns");
  static_assert(kTileBytes % 1024 == 0 && (kSliceRows * 128) % 1024 == 0, "swizzle atoms");
  static_assert(kSmemBytes <= kSmemMax, "shared memory");
};

// The x map, up to three W maps (one per B slice) and up to three output
// maps (64-column × 64-row boxes), for TMA from the kernel's parameter space.
struct Maps {
  CUtensorMap x;
  CUtensorMap w[3];
  CUtensorMap out[3];
};

__global__ void __launch_bounds__(256)
ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int M, int C,
                float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  float s1 = 0.f, s2 = 0.f;
  for (int c8 = lane; c8 < C / 8; c8 += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c8 * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float mu = s1 / C;
    stats[row] = make_float2(mu, rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps));
  }
}

// Two raw bf16 x values (lo, hi) of one row → LN in fp32 → packed bf16.
__device__ __forceinline__ uint32_t ln_pack(uint32_t u, float2 st, float2 w, float2 b) {
  const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
  return pack_bf16x2(fmaf((lo - st.x) * st.y, w.x, b.x), fmaf((hi - st.x) * st.y, w.y, b.y));
}

// Two raw bf16 x values of one row → x·w + b in fp32 (not fused into one
// rounding, as the plain version computes it) → packed bf16.
__device__ __forceinline__ uint32_t gn_pack(uint32_t u, float2 w, float2 b) {
  const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
  return pack_bf16x2(__fadd_rn(__fmul_rn(lo, w.x), b.x), __fadd_rn(__fmul_rn(hi, w.y), b.y));
}

template <Kind K, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_kernel(const __grid_constant__ Maps maps, const float2* __restrict__ stats,
               const float* __restrict__ lw, const float* __restrict__ lb, const Epi epi, int M,
               int C, int N, int S) {
  using T = Traits<K>;
  constexpr int ST = T::kStages, BN = T::kBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kOffBar);
  uint64_t* empty = full + ST;
  const int n_ct = (N + T::kSliceRows - 1) / T::kSliceRows;
  const int n_tiles = ((M + kBM - 1) / kBM) * n_ct, n_k = C / kBK;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&maps.x);
      for (int i = 0; i < T::kSlices; ++i) tma_prefetch_desc(&maps.w[i]);
      int seq = 0;  // ring stages filled so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int row = (t / n_ct) * kBM, wrow = (t % n_ct) * T::kSliceRows;
        for (int k = 0; k < n_k; ++k, ++seq) {
          const int s = seq % ST;
          if (seq >= ST) mbar_wait(&empty[s], ((seq / ST) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], T::kStageBytes);
          unsigned char* tile = smem + s * T::kTileBytes;
          tma_load_3d(tile, &maps.x, &full[s], k * kBK, 0, row);
          for (int i = 0; i < T::kSlices; ++i)
            tma_load_3d(tile + kXBytes + i * T::kSliceRows * 128, &maps.w[i], &full[s], k * kBK,
                        0, wrow);
          unsigned char* vec = smem + T::kOffVec + s * T::kVecBytes;
          if constexpr (K == Kind::kGn) {
            // lw, lb are the (B, C) affine; the tile's rows lie in batch
            // elements row / S and at most the next one
            const int b0 = row / S, b1 = min(b0 + 1, M / S - 1);
            for (int i = 0; i < 2; ++i) {
              const size_t off = static_cast<size_t>(i == 0 ? b0 : b1) * C + k * kBK;
              bulk_load(vec + i * 2 * kBK * 4, lw + off, kBK * 4, &full[s]);
              bulk_load(vec + (2 * i + 1) * kBK * 4, lb + off, kBK * 4, &full[s]);
            }
          } else {
            bulk_load(vec, lw + k * kBK, kBK * 4, &full[s]);
            bulk_load(vec + kBK * 4, lb + k * kBK, kBK * 4, &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int c = wg;  // a tile's rows 64c .. 64c + 63
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    // ldmatrix row addresses: lanes 0-7 rows 0-7 and 8-15 rows 8-15 of the
    // warp's 16 at columns 0-7 of a k16 step, lanes 16-31 the same at 8-15;
    // the 128-byte swizzle puts 16-byte chunk j of row r at j ^ (r % 8)
    const uint32_t lrow = 64 * c + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const uint32_t xoff = lrow * 128;
    const uint32_t sw = lane & 7, khalf = lane >> 4;

    int seq = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ct = t % n_ct;
      const int row = (t / n_ct) * kBM + 64 * c + 16 * warp + g;  // and row + 8
      float2 st0 = {}, st1 = {};  // the LayerNorm kinds: the two rows' (μ, rstd)
      int sl0 = 0, sl1 = 0;  // Kind::kGn: their batch slots' w in the stage (float2s)
      if constexpr (K == Kind::kGn) {
        const int b0 = ((t / n_ct) * kBM) / S;
        sl0 = (row / S - b0) * kBK;
        sl1 = ((row + 8) / S - b0) * kBK;
      } else {
        st0 = stats[row];
        st1 = stats[row + 8];
      }

      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < n_k; ++k, ++seq) {
        const int s = seq % ST;
        mbar_wait(&full[s], (seq / ST) & 1);
        const uint32_t xs = smem_addr(smem) + s * T::kTileBytes;
        const uint32_t bs = xs + kXBytes;
        const float2* vw = reinterpret_cast<const float2*>(smem + T::kOffVec + s * T::kVecBytes);
        const float2* vb = vw + kBK / 2;

        uint32_t a[kBK / 16][4];  // the A fragments of the chunk's four k16 steps
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          ldmatrix_x4(a[kk], xs + xoff + (((2 * kk + khalf) ^ sw) << 4));
          const int cp = 8 * kk + tig;  // column pair 16kk + 2·tig (+1); + 4 pairs: + 8
          if constexpr (K == Kind::kGn) {
            const float2 *v0 = vw + sl0, *v1 = vw + sl1;  // w, then b 32 float2s on
            a[kk][0] = gn_pack(a[kk][0], v0[cp], v0[cp + kBK / 2]);
            a[kk][1] = gn_pack(a[kk][1], v1[cp], v1[cp + kBK / 2]);
            a[kk][2] = gn_pack(a[kk][2], v0[cp + 4], v0[cp + 4 + kBK / 2]);
            a[kk][3] = gn_pack(a[kk][3], v1[cp + 4], v1[cp + 4 + kBK / 2]);
          } else {
            const float2 w0 = vw[cp], w1 = vw[cp + 4], b0 = vb[cp], b1 = vb[cp + 4];
            a[kk][0] = ln_pack(a[kk][0], st0, w0, b0);
            a[kk][1] = ln_pack(a[kk][1], st1, w0, b0);
            a[kk][2] = ln_pack(a[kk][2], st0, w1, b1);
            a[kk][3] = ln_pack(a[kk][3], st1, w1, b1);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<BN>(acc, a[kk], wgmma_desc(bs + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if constexpr (T::kOutBoxes == 0) {
        epi.store(acc, row, ct, tig);
      } else {
        // bf16 through stmatrix into this warpgroup's 64-row output boxes
        // (128-byte swizzled: 16-byte chunk j of row r at j ^ (r % 8)),
        // then TMA stores issued by its first thread, which run while the
        // next tile's products do; before the boxes are written again that
        // thread waits until the previous stores have read them
        const bool leader = threadIdx.x % 128 == 0;
        const uint32_t ob = smem_addr(smem) + T::kOffOut + c * T::kOutBytes;
        if (leader) bulk_wait_read<0>();
        named_sync(1 + c, 128);
        const int i = lane >> 3;                            // this lane's matrix
        const int orow = 16 * warp + (lane & 7) + 8 * (i & 1);  // its row in the boxes
#pragma unroll
        for (int jb = 0; jb < 8 * T::kOutBoxes; jb += 2) {  // 8-column blocks, two at a time
          uint32_t r[4];
          epi.pack(acc, jb, ct, tig, r[0], r[1]);
          epi.pack(acc, jb + 1, ct, tig, r[2], r[3]);
          const int cb = jb + (i >> 1);
          stmatrix_x4(ob + (cb / 8) * 8192 + orow * 128 + (((cb % 8) ^ (orow & 7)) << 4), r);
        }
        fence_async_shared();
        named_sync(1 + c, 128);
        if (leader) {
          const int orow0 = (t / n_ct) * kBM + 64 * c;
#pragma unroll
          for (int b = 0; b < T::kOutBoxes; ++b)
            tma_store_3d(&maps.out[Epi::out_map(b)], smem + T::kOffOut + c * T::kOutBytes + b * 8192,
                         Epi::out_col(ct, b), 0, orow0);
          bulk_commit();
        }
      }
    }
    if constexpr (T::kOutBoxes > 0) {
      if (threadIdx.x % 128 == 0) bulk_wait_read<0>();  // the boxes outlive their stores
    }
  }
}

// The stats pass (not for Kind::kGn), then the GEMM. `w[i]` is slice i's
// weight, N rows of C; `out[i]` output i, M rows of N (Epi::kOutputs of
// them). Kind::kGn: lw, lb are the (M / S, C) affine and stats is unused.
template <Kind K, typename Epi>
cudaError_t launch(const bf16* x, const float* lw, const float* lb, const bf16* const (&w)[3],
                   bf16* const (&out)[3], const Epi& epi, float2* stats, int M, int C, int N,
                   float eps, cudaStream_t st, int S = 0) {
  using T = Traits<K>;
  const bool rows_ok = K == Kind::kGn ? S > 0 && S % 64 == 0 && M % S == 0 : M % kBM == 0;
  if (M <= 0 || !rows_ok || C <= 0 || C % kBK != 0 || N <= 0 || N % 8 != 0 || sm_count() == 0)
    return cudaErrorInvalidValue;
  Maps maps{};
  if (!bf16_rows_map(&maps.x, x, M, 1, C, kBM)) return cudaErrorInvalidValue;
  for (int i = 0; i < T::kSlices; ++i)
    if (!bf16_rows_map(&maps.w[i], w[i], N, 1, C, T::kSliceRows)) return cudaErrorInvalidValue;
  if (T::kOutBoxes > 0)
    for (int i = 0; i < Epi::kOutputs; ++i)
      if (!bf16_rows_map(&maps.out[i], out[i], M, 1, N, 64)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ln_gemm_kernel<K, Epi>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  if (K != Kind::kGn) {
    ln_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, stats, M, C, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = ((M + kBM - 1) / kBM) * ((N + T::kSliceRows - 1) / T::kSliceRows);
  ln_gemm_kernel<K, Epi><<<std::min(n_tiles, sm_count()), kThreads, T::kSmemBytes, st>>>(
      maps, stats, lw, lb, epi, M, C, N, S);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lnsm90
}  // namespace psd
