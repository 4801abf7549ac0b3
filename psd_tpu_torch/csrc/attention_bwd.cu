// attention_bwd: the gradient of non-causal softmax attention,
//   O = softmax(Q·Kᵀ·scale)·V,  (B, S, H, D) bf16 operands, D <= 160,
// given dO, O and the forward's per-row log-sum-exp (attention_narrow.cu,
// log2 units, fp32 (B, H, Sq)). Writes dQ, dK, dV (bf16, the operands'
// layout).
//
// Replaces the backward of JAX's stock Pallas flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, its dq and dkv kernels),
// which psd_tpu/ops/flash.py:104-121 configures and psd_tpu trains with.
//
// What bounds it on the H100. At the 256² training shape (64, 1024, 8, 40)
// the gradient takes five S²-sized products (S, dP, dV, dK, dQ): at the
// padded Dp = 48, 5·2·B·H·S²·Dp = 258 GFLOP, 0.26 ms at 989 TFLOP/s,
// against ≈ 0.34 GB of operands and gradients. The dQ pass below computes
// S and dP again (7 products, 0.365 ms), and each pass takes one exp2 a
// logit on the SFU, 16 a clock on each SM: B·H·S² = 537 M exp2, 0.128 ms a
// pass at 1.98 GHz, beside the dS elementwise work on the CUDA cores. So the
// products and the softmax work share the floor. Measured (PERF.md §6 PR 7),
// the call sits at ≈ 2.6× that floor, held by two near-equal limits: the
// ring refills (rows of 80 bytes at D = 40 streamed by TMA from L2; with no
// products, exp2 or dS work the passes still take 0.92 of 1.04 ms at
// (64, 1024, 8, 40)) and each consumer warpgroup's serial chain of products
// and elementwise work (0.98 ms with the rings never refilled).
//
// Two launches, no atomics, deterministic, the dQ pass first. Each pass is
// persistent: one block an SM walks the pass's work items (128 resident
// rows of one b·h) in turn, its producer loading the next item's resident
// tiles (into a second buffer where shared memory allows) and ring tiles
// while the consumers finish the current one; a block for each item was
// 7% slower at (64, 1024, 8, 40) and 24% at (8, 1024, 8, 80) (PERF.md §6
// PR 7).
//  1. dq_kernel<Dp>: items of 128 query rows, PR 6's forward with one more
//     product and no online max. Two consumer warpgroups (64 rows each,
//     wgmma's M) and a producer warpgroup whose registers go to the
//     consumers (setmaxnreg 24 / 240). The producer loads an item's q and
//     dO by TMA, then its K and V tiles of kBK keys into a ring of mbarrier
//     stages. Each consumer first takes Δ = rowsum(dO ∘ O) of its two rows
//     from global memory (the four lanes of a row split its 16-byte chunks)
//     while q and dO arrive, and writes it (fp32 (B, H, Sq)) for the dK/dV
//     pass: 0.04–0.10 ms faster at the training shapes than a Δ kernel of
//     its own, which kept 5 of a warp's 32 lanes busy at D = 40 (PERF.md §6
//     PR 7).
//     Per tile: S = q·Kᵀ and dP = dO·Vᵀ (wgmma_ss<kBK>, K-major operands,
//     Dp/16 k-steps each), P = 2^(S·scale·log2e − lse), dS = P∘(dP − Δ)
//     packed to bf16 straight from the accumulators as A register
//     fragments, then dQ += dS·K (wgmma_rs_tb<Dp>, K MN-major).
//  2. dkv_kernel<Dp>: items of 128 key rows, two consumer warpgroups of 64
//     keys, each with its dK and dV (64 × Dp fp32) in registers. An item's
//     K and V arrive by TMA once; the producer fills a ring of (Q, dO)
//     tiles of kBQ queries, with those queries' lse and Δ by bulk copy on
//     the same mbarrier. Per tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//     (wgmma_ss<kBQ>), Pᵀ = 2^(Sᵀ·scale·log2e − lse[col]), dSᵀ =
//     Pᵀ∘(dPᵀ − Δ[col]); Pᵀ and dSᵀ packed to bf16 as A fragments; dV +=
//     Pᵀ·dO and dK += dSᵀ·Q (wgmma_rs_tb<Dp>, dO and Q MN-major). The stage
//     is released once wgmma.wait_group says both products have read it.
// dQ is a pass of its own, computing S and dP again, instead of adding dQ
// across key blocks with fp32 atomics: the result does not depend on the
// order blocks run in (ROADMAP Decisions). The two consumer warpgroups of a
// pass run independently: taking turns on the tensor cores, as the
// forward's do (two named barriers, each issuing its first products once
// the other's have completed), was 1–4% slower here at the three training
// shapes (PERF.md §6 PR 7), where the products, not the exp2, outweigh the
// elementwise work.
// Every exp2 is one ex2.approx. Tiles are 64-column boxes with the 128-byte
// swizzle from 3-D (D, H, B·S) tensor maps, so columns D..Dp arrive as
// zeros and never reach an output; gradients are written for columns < D.
// Requires D % 8 == 0, D <= 160, Sq % 128 == 0 and Sk % 128 == 0 (the
// wrapper checks: ops/attention.py::bwd_shape_error).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace {

using namespace hopper;

constexpr int kRows = 128;     // an item's query rows (dQ) or key rows (dK/dV): 64 a WG
constexpr int kThreads = 384;  // two consumer WGs, then the producer WG
constexpr size_t kSmemMax = 232448;  // the shared memory of the one block an SM

// 2^x on the SFU: one MUFU.EX2 (ex2.approx.ftz; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The deepest ring (up to 4 stages) that fits beside `fixed` bytes.
constexpr int ring_depth(size_t fixed, size_t stage) {
  return (kSmemMax - 1024 - 128 - fixed) / stage >= 4
             ? 4
             : static_cast<int>((kSmemMax - 1024 - 128 - fixed) / stage);
}

// Two buffers of the resident tiles (the next work item's load under this
// one's products) where the ring keeps 3 stages beside them, else one.
constexpr int resident_buffers(size_t resident, size_t stage) {
  return ring_depth(2 * resident, stage) >= 3 ? 2 : 1;
}

// dQ pass tiling: q and dO (128 rows each) resident, in one or two
// buffers, a ring of K and V tiles of kBK keys. 128-key tiles where S, dP,
// dQ and the packed dS fit the consumers' 240 registers (Dp <= 80), 64-key
// tiles above. (Two blocks an SM at 112 registers a thread spilled and
// were 1.2× slower at D = 40: PERF.md §6 PR 7.)
template <int DP>
struct DqPass {
  static constexpr int kBoxes = (DP + 63) / 64;
  static constexpr int kBK = DP <= 80 ? 128 : 64;
  static constexpr uint32_t kRowsBytes = kRows * kBoxes * 128;  // q or dO
  static constexpr uint32_t kTileBytes = kBK * kBoxes * 128;   // one K or one V tile
  static constexpr int kResBufs = resident_buffers(2 * kRowsBytes, 2 * kTileBytes);
  static constexpr int kStages = ring_depth(kResBufs * 2 * kRowsBytes, 2 * kTileBytes);
  static constexpr uint32_t kOffKV = kResBufs * 2 * kRowsBytes;  // stage s: K, then V
  static constexpr uint32_t kOffBar = kOffKV + kStages * 2 * kTileBytes;
  static constexpr size_t kSmemBytes = kOffBar + 8 * 2 * (kResBufs + kStages) + 1024;
  static_assert(DP % 16 == 0 && DP <= 160, "Dp <= 160");
  static_assert(kStages >= 2 && kSmemBytes <= kSmemMax, "shared memory");
};

// dK/dV pass tiling: K and V (128 rows each) resident, in one or two
// buffers, a ring of (Q, dO) tiles of kBQ queries with their lse and Δ.
// dK, dV, Sᵀ, dPᵀ and the packed Pᵀ, dSᵀ take Dp + 3·kBQ/2 registers:
// 64-query tiles up to Dp = 96, 32-query tiles above.
template <int DP>
struct DkvPass {
  static constexpr int kBoxes = (DP + 63) / 64;
  static constexpr int kBQ = DP <= 96 ? 64 : 32;
  static constexpr uint32_t kRowsBytes = kRows * kBoxes * 128;  // K or V
  static constexpr uint32_t kTileBytes = kBQ * kBoxes * 128;   // one Q or one dO tile
  static constexpr uint32_t kVecBytes = kBQ * 4;              // the tile's lse or Δ
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + 2 * kVecBytes;
  static constexpr int kResBufs = resident_buffers(2 * kRowsBytes, kStageBytes);
  static constexpr int kStages = ring_depth(kResBufs * 2 * kRowsBytes, kStageBytes);
  static constexpr uint32_t kOffRing = kResBufs * 2 * kRowsBytes;  // stage s: Q, then dO
  static constexpr uint32_t kOffVec = kOffRing + kStages * 2 * kTileBytes;  // lse, then Δ
  static constexpr uint32_t kOffBar = kOffVec + kStages * 2 * kVecBytes;
  static constexpr size_t kSmemBytes = kOffBar + 8 * 2 * (kResBufs + kStages) + 1024;
  static_assert(DP % 16 == 0 && DP <= 160, "Dp <= 160");
  static_assert(kStages >= 2 && kSmemBytes <= kSmemMax, "shared memory");
};

// A pass's work item: 128 resident rows (query rows for dQ, key rows for
// dK/dV) of one b·h; items w run x fastest, so a head's items run together.
struct Item {
  int x, b, h, bh;
};

__device__ __forceinline__ Item item_of(int w, int nx, int H) {
  const int bh = w / nx;
  return {w % nx, bh / H, bh % H, bh};
}

// The mbarriers of a pass: the resident tiles' (full: TMA bytes landed;
// empty: the 8 consumer warps are done with them) and the ring's, each
// full barrier with one arrival (the producer's, with the bytes).
struct Bars {
  uint64_t *rfull, *rempty, *full, *empty;
};

template <int RB, int ST>
__device__ __forceinline__ Bars init_bars(unsigned char* at) {
  uint64_t* b = reinterpret_cast<uint64_t*>(at);
  const Bars bars{b, b + RB, b + 2 * RB, b + 2 * RB + ST};
  if (threadIdx.x == 0) {
    for (int i = 0; i < RB; ++i) {
      mbar_init(&bars.rfull[i], 1);
      mbar_init(&bars.rempty[i], 8);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return bars;
}

// Σ of the products of two runs of 8 bf16, in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, fmaf(u.y, v.y, s));
  }
  return s;
}

// A K-major product over the head dim: acc (=|+)= A[64 rows]·B[N rows]ᵀ,
// both tiles as TMA wrote them (64-column boxes of `a_rows` / `b_rows` rows,
// 128 B a row, swizzled); a k16 step moves 32 B inside a box.
template <int N, int DP>
__device__ __forceinline__ void product_over_d(float (&acc)[N / 2], uint32_t a, int a_rows,
                                               uint32_t bt, int b_rows) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t box = ks >> 2, in_box = (ks & 3) * 32;
    wgmma_ss<N>(acc, wgmma_desc(a + box * (a_rows * 128) + in_box, 16, 1024),
                wgmma_desc(bt + box * (b_rows * 128) + in_box, 16, 1024), ks > 0);
  }
}

// acc += A·B over `rows` rows of B (K = rows, N = Dp): A from registers
// (k16 fragments), B MN-major as TMA wrote it: the leading offset steps one
// 64-column box (rows · 128 B), the stride offset 8 rows (1024 B).
template <int ROWS, int DP>
__device__ __forceinline__ void product_over_rows(float (&acc)[DP / 2],
                                                  const uint32_t (&a)[ROWS / 16][4],
                                                  uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_rs_tb<DP>(acc, a[kk], wgmma_desc(bt + kk * 16 * 128, ROWS * 128, 1024), 1);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// Rows `row` and row + 8 of a (B, S, H, D) gradient from a 64 × Dp
// accumulator (m64nDp layout), times `mul`; columns past D are dropped.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ g, const float (&acc)[DP / 2],
                                           int b, int S, int row, int H, int h, int D, int tig,
                                           float mul) {
  const size_t row_stride = static_cast<size_t>(H) * D;
  bf16* r0 = g + (static_cast<size_t>(b) * S + row) * row_stride + static_cast<size_t>(h) * D;
  bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (n * 8 < D) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
          __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const bf16* __restrict__ out, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
          int B, int Sq, int Sk, int H, int D, float scale, float scale_log2) {
  using T = DqPass<DP>;
  constexpr int BK = T::kBK, NB = T::kBoxes, ST = T::kStages, RB = T::kResBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Bars bars = init_bars<RB, ST>(smem + T::kOffBar);
  const int nx = Sq / kRows, n_items = nx * B * H, n_tiles = Sk / BK;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer

  if (wg == 2) {
    // ---- producer: each item's q and dO, then its K and V tiles ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tdo);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      int seq = 0, it = 0;  // ring tiles and items so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const Item m = item_of(w, nx, H);
        const int rb = it % RB;
        if (it >= RB) mbar_wait(&bars.rempty[rb], ((it / RB) - 1) & 1);
        unsigned char* res = smem + rb * 2 * T::kRowsBytes;
        mbar_arrive_expect_tx(&bars.rfull[rb], 2 * T::kRowsBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(res + c * kRows * 128, &tq, &bars.rfull[rb], c * 64, m.h,
                      m.b * Sq + m.x * kRows);
          tma_load_3d(res + T::kRowsBytes + c * kRows * 128, &tdo, &bars.rfull[rb], c * 64, m.h,
                      m.b * Sq + m.x * kRows);
        }
        for (int t = 0; t < n_tiles; ++t, ++seq) {
          const int s = seq % ST;
          if (seq >= ST) mbar_wait(&bars.empty[s], ((seq / ST) - 1) & 1);
          mbar_arrive_expect_tx(&bars.full[s], 2 * T::kTileBytes);
          unsigned char* kt = smem + T::kOffKV + s * 2 * T::kTileBytes;
          const int row = m.b * Sk + t * BK;
          for (int c = 0; c < NB; ++c) {
            tma_load_3d(kt + c * BK * 128, &tk, &bars.full[s], c * 64, m.h, row);
            tma_load_3d(kt + T::kTileBytes + c * BK * 128, &tv, &bars.full[s], c * 64, m.h, row);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int c = wg;  // an item's query rows 64c .. 64c + 63
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    const size_t row_stride = static_cast<size_t>(H) * D;

    int seq = 0, it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const Item m = item_of(w, nx, H);
      const int rb = it % RB;
      const int row = m.x * kRows + 64 * c + 16 * warp + g;
      const size_t vr = static_cast<size_t>(m.bh) * Sq + row;
      const float l0 = lse[vr], l1 = lse[vr + 8];

      // Δ of rows `row` and row + 8 = Σ_d dO·O, each of the row's four lanes
      // taking every fourth 16-byte chunk, while q and dO arrive
      const size_t at =
          (static_cast<size_t>(m.b) * Sq + row) * row_stride + static_cast<size_t>(m.h) * D;
      float d0 = 0.f, d1 = 0.f;
      for (int c8 = tig; c8 < D / 8; c8 += 4) {
        const size_t e = at + c8 * 8;
        d0 += dot8(*reinterpret_cast<const uint4*>(dout + e),
                   *reinterpret_cast<const uint4*>(out + e));
        d1 += dot8(*reinterpret_cast<const uint4*>(dout + e + 8 * row_stride),
                   *reinterpret_cast<const uint4*>(out + e + 8 * row_stride));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, o_);
        d1 += __shfl_xor_sync(0xffffffffu, d1, o_);
      }
      if (tig == 0) {  // for the dK/dV pass
        delta[vr] = d0;
        delta[vr + 8] = d1;
      }

      float acc[DP / 2];  // dQ, m64nDp: acc[4n + e], columns 8n + 2·tig (+1)
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
      // this WG's 64 rows of each q / dO box start 64 rows (8 KB, whole swizzle atoms) in
      const uint32_t qs = smem_addr(smem) + rb * 2 * T::kRowsBytes + c * 64 * 128;
      const uint32_t os = qs + T::kRowsBytes;
      mbar_wait(&bars.rfull[rb], (it / RB) & 1);
      for (int t = 0; t < n_tiles; ++t, ++seq) {
        const int s = seq % ST;
        mbar_wait(&bars.full[s], (seq / ST) & 1);
        const uint32_t kst = smem_addr(smem) + T::kOffKV + s * 2 * T::kTileBytes;
        const uint32_t vst = kst + T::kTileBytes;

        float sc[BK / 2], dp[BK / 2];  // S = q·Kᵀ and dP = dO·Vᵀ, 64 × BK
        wgmma_fence();
        product_over_d<BK, DP>(sc, qs, kRows, kst, BK);
        product_over_d<BK, DP>(dp, os, kRows, vst, BK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // dS = P∘(dP − Δ) as the A fragments of m64k16: keys 16kk + (0..15);
        // rows g (e = 0, 1) and g + 8 (e = 2, 3)
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float p0 = ex2(sc[4 * j] * scale_log2 - l0);
          const float p1 = ex2(sc[4 * j + 1] * scale_log2 - l0);
          const float p2 = ex2(sc[4 * j + 2] * scale_log2 - l1);
          const float p3 = ex2(sc[4 * j + 3] * scale_log2 - l1);
          da[j / 2][(j % 2) * 2] = pack_bf16x2(p0 * (dp[4 * j] - d0), p1 * (dp[4 * j + 1] - d0));
          da[j / 2][(j % 2) * 2 + 1] =
              pack_bf16x2(p2 * (dp[4 * j + 2] - d1), p3 * (dp[4 * j + 3] - d1));
        }

        // dQ += dS · K_tile, K MN-major (the head dim contiguous)
        wgmma_fence();
        product_over_rows<BK, DP>(acc, da, kst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars.empty[s]);  // this warp is done with stage s
      }
      if (lane == 0) mbar_arrive(&bars.rempty[rb]);  // and with the item's q and dO
      store_rows<DP>(dq, acc, m.b, Sq, row, H, m.h, D, tig, scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Sk, int H, int D,
           float scale, float scale_log2) {
  using T = DkvPass<DP>;
  constexpr int BQ = T::kBQ, NB = T::kBoxes, ST = T::kStages, RB = T::kResBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Bars bars = init_bars<RB, ST>(smem + T::kOffBar);
  const int nx = Sk / kRows, n_items = nx * B * H, n_tiles = Sq / BQ;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer

  if (wg == 2) {
    // ---- producer: each item's K and V, then its (Q, dO, lse, Δ) tiles ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tdo);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      int seq = 0, it = 0;  // ring tiles and items so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const Item m = item_of(w, nx, H);
        const int rb = it % RB;
        if (it >= RB) mbar_wait(&bars.rempty[rb], ((it / RB) - 1) & 1);
        unsigned char* res = smem + rb * 2 * T::kRowsBytes;
        mbar_arrive_expect_tx(&bars.rfull[rb], 2 * T::kRowsBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(res + c * kRows * 128, &tk, &bars.rfull[rb], c * 64, m.h,
                      m.b * Sk + m.x * kRows);
          tma_load_3d(res + T::kRowsBytes + c * kRows * 128, &tv, &bars.rfull[rb], c * 64, m.h,
                      m.b * Sk + m.x * kRows);
        }
        const float* lrow = lse + static_cast<size_t>(m.bh) * Sq;
        const float* drow = delta + static_cast<size_t>(m.bh) * Sq;
        for (int t = 0; t < n_tiles; ++t, ++seq) {
          const int s = seq % ST;
          if (seq >= ST) mbar_wait(&bars.empty[s], ((seq / ST) - 1) & 1);
          mbar_arrive_expect_tx(&bars.full[s], T::kStageBytes);
          unsigned char* qt = smem + T::kOffRing + s * 2 * T::kTileBytes;
          const int row = m.b * Sq + t * BQ;
          for (int c = 0; c < NB; ++c) {
            tma_load_3d(qt + c * BQ * 128, &tq, &bars.full[s], c * 64, m.h, row);
            tma_load_3d(qt + T::kTileBytes + c * BQ * 128, &tdo, &bars.full[s], c * 64, m.h, row);
          }
          unsigned char* vec = smem + T::kOffVec + s * 2 * T::kVecBytes;
          bulk_load(vec, lrow + t * BQ, T::kVecBytes, &bars.full[s]);
          bulk_load(vec + T::kVecBytes, drow + t * BQ, T::kVecBytes, &bars.full[s]);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int c = wg;  // an item's key rows 64c .. 64c + 63
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;

    int seq = 0, it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const Item m = item_of(w, nx, H);
      const int rb = it % RB;
      const uint32_t ks = smem_addr(smem) + rb * 2 * T::kRowsBytes + c * 64 * 128;  // K rows
      const uint32_t vs = ks + T::kRowsBytes;                                        // V rows

      float dka[DP / 2], dva[DP / 2];  // m64nDp: [4n + e], columns 8n + 2·tig (+1)
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
      mbar_wait(&bars.rfull[rb], (it / RB) & 1);
      for (int t = 0; t < n_tiles; ++t, ++seq) {
        const int s = seq % ST;
        mbar_wait(&bars.full[s], (seq / ST) & 1);
        const uint32_t qst = smem_addr(smem) + T::kOffRing + s * 2 * T::kTileBytes;
        const uint32_t ost = qst + T::kTileBytes;
        const float* lv = reinterpret_cast<const float*>(smem + T::kOffVec + s * 2 * T::kVecBytes);
        const float* dl = lv + BQ;

        float st[BQ / 2], dpt[BQ / 2];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ: 64 keys × BQ queries
        wgmma_fence();
        product_over_d<BQ, DP>(st, ks, kRows, qst, BQ);
        product_over_d<BQ, DP>(dpt, vs, kRows, ost, BQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // Pᵀ and dSᵀ as the A fragments of m64k16 (queries 16kk + (0..15));
        // this thread's columns are queries 8j + 2·tig (+1)
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lv + 8 * j + 2 * tig);
          const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tig);
          const float p0 = ex2(st[4 * j] * scale_log2 - l.x);
          const float p1 = ex2(st[4 * j + 1] * scale_log2 - l.y);
          const float p2 = ex2(st[4 * j + 2] * scale_log2 - l.x);
          const float p3 = ex2(st[4 * j + 3] * scale_log2 - l.y);
          pa[j / 2][(j % 2) * 2] = pack_bf16x2(p0, p1);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2, p3);
          da[j / 2][(j % 2) * 2] =
              pack_bf16x2(p0 * (dpt[4 * j] - d.x), p1 * (dpt[4 * j + 1] - d.y));
          da[j / 2][(j % 2) * 2 + 1] =
              pack_bf16x2(p2 * (dpt[4 * j + 2] - d.x), p3 * (dpt[4 * j + 3] - d.y));
        }

        // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q MN-major
        wgmma_fence();
        product_over_rows<BQ, DP>(dva, pa, ost);
        product_over_rows<BQ, DP>(dka, da, qst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars.empty[s]);  // this warp is done with stage s
      }
      if (lane == 0) mbar_arrive(&bars.rempty[rb]);  // and with the item's K and V
      const int row = m.x * kRows + 64 * c + 16 * warp + g;
      store_rows<DP>(dk, dka, m.b, Sk, row, H, m.h, D, tig, scale);
      store_rows<DP>(dv, dva, m.b, Sk, row, H, m.h, D, tig, 1.f);
    }
  }
}

template <int DP>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                       const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                       bf16* dv, int B, int Sq, int Sk, int H, int D, float scale,
                       cudaStream_t st) {
  using Q = DqPass<DP>;
  using KV = DkvPass<DP>;
  if (Sq % kRows != 0 || Sk % kRows != 0 || sm_count() == 0) return cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  CUtensorMap tq, tdo, tk, tv;
  if (!bf16_rows_map(&tq, q, B * Sq, H, D, kRows) ||
      !bf16_rows_map(&tdo, dout, B * Sq, H, D, kRows) ||
      !bf16_rows_map(&tk, k, B * Sk, H, D, Q::kBK) || !bf16_rows_map(&tv, v, B * Sk, H, D, Q::kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dq_kernel<DP>, Q::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int dq_items = Sq / kRows * B * H;
  dq_kernel<DP><<<std::min(dq_items, sm_count()), kThreads, Q::kSmemBytes, st>>>(
      tq, tdo, tk, tv, out, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!bf16_rows_map(&tq, q, B * Sq, H, D, KV::kBQ) ||
      !bf16_rows_map(&tdo, dout, B * Sq, H, D, KV::kBQ) ||
      !bf16_rows_map(&tk, k, B * Sk, H, D, kRows) || !bf16_rows_map(&tv, v, B * Sk, H, D, kRows))
    return cudaErrorInvalidValue;
  err = allow_smem(dkv_kernel<DP>, KV::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int dkv_items = Sk / kRows * B * H;
  dkv_kernel<DP><<<std::min(dkv_items, sm_count()), kThreads, KV::kSmemBytes, st>>>(
      tq, tdo, tk, tv, lse, delta, dk, dv, B, Sq, Sk, H, D, scale, sl2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace psd

// The padded head dims the kernels are built for; a D between two of them
// is zero-filled up to the next by TMA.
extern "C" int psd_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                 float scale, void* stream) {
  using namespace psd;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(out);
  const bf16* gp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define PSD_BWD(DP) \
  launch_bwd<DP>(qp, kp, vp, op, gp, lp, dl, dqp, dkp, dvp, B, Sq, Sk, H, D, scale, st)
  cudaError_t err = cudaErrorInvalidValue;
  const int dp = (D + 15) / 16 * 16;
  if (dp <= 32) err = PSD_BWD(32);
  else if (dp <= 48) err = PSD_BWD(48);
  else if (dp <= 64) err = PSD_BWD(64);
  else if (dp <= 80) err = PSD_BWD(80);
  else if (dp <= 96) err = PSD_BWD(96);
  else if (dp <= 128) err = PSD_BWD(128);
  else if (dp <= 160) err = PSD_BWD(160);
#undef PSD_BWD
  return static_cast<int>(err);
}
