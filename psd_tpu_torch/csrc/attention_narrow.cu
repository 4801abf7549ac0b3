// The attention forward for narrow heads, Dp = ceil16(D) <= 160 (the UNet
// self-attention: D = 40 at S = 4096, D = 80 at S = 1024, 8 heads):
// non-causal softmax(q·kᵀ·scale)·v, (B, S, H, D) bf16 in and out, fp32
// logits and accumulators.
//
// Replaces psd_tpu/ops/spattn.py::_kernel (the spattn role) and, at these
// head dims, the forward of JAX's stock Pallas flash kernel that
// psd_tpu/ops/flash.py::flash_attention wraps (the flash role, and the
// forward of training's attention, which asks for the row log-sum-exp).
//
// What bounds it on the H100. At (8, 4096, 8, 40) the two products are
// 4·B·H·S²·Dp = 206 GFLOP at the padded Dp = 48, 0.21 ms at 989 TFLOP/s,
// against 10 MB of q/k/v/out. But every logit also takes one exp2 on the
// SFU, 16 a clock on each SM: B·H·S² = 1.07 G exp2, ≈ 0.26 ms at 1.98 GHz,
// and the max, the scale, the bf16 packing and the sum of the rounded p
// run on the CUDA cores beside it. So the softmax, not the tensor cores,
// sets the floor, and the design keeps the tensor cores busy under it:
//  * One block per (128 query rows, b·h). Two consumer warpgroups (WG 0
//    and WG 1) each own 64 query rows (wgmma's M) and their 64×Dp fp32 O in
//    registers (Dp/2 a thread). After them, the producer: one thread
//    issues TMA loads (q once; then K and V tiles of kBK keys into a ring
//    of kStages, each completed on its stage's full mbarrier).
//  * At Dp ≤ 64 two blocks share an SM (four consumer WGs to hide each
//    other's waits), with 64-key tiles and a producer warp, every thread
//    at 112 registers. Above, one block an SM with 128-key tiles (64 at
//    Dp = 160, for shared memory): the producer is a warpgroup that gives
//    its registers to the consumers (setmaxnreg 24 / 240). On an H100 two
//    blocks an SM are 7% faster at D = 40 and, with the 80-wide O spilling
//    at 112 registers, 1.5× slower at D = 80 (PERF.md §6 PR 6).
//  * Shared memory holds every tile as TMA wrote it, boxes of 64 columns
//    (128 B) with the 128-byte swizzle. The maps are 3-D (D, H, B·S) with a
//    box of 64 columns × one head, so columns D..63 of a box arrive as
//    zeros (a 2-D (rows, H·D) map would fill them from head h + 1).
//  * S = q·kᵀ (64 × kBK) is one wgmma m64n{kBK}k16 per 16 of depth, both
//    operands from shared memory, K-major: Dp/16 steps (3 at Dp = 48, 5 at
//    80).
//  * Online softmax in registers (row max and sum over the 4 lanes that
//    share a row; exp2 as one ex2.approx); O is rescaled by
//    exp2(m_old − m_new).
//  * P·V: P is packed to bf16 straight from the S accumulator, which is
//    the A register fragment of wgmma m64nDpk16; kBK/16 of them take it
//    from registers with B = V[keys, 0:Dp] from shared memory. V lies
//    key-major, so B is MN-major (transposed): the descriptor's leading
//    offset steps one 64-column box (kBK rows · 128 B), its stride offset
//    8 keys (1024 B).
//  * Once wgmma.wait_group says P·V has read a stage, each consumer warp
//    arrives on the stage's empty mbarrier; the producer waits on it
//    before the refill.
//  * The two consumer WGs of a block run out of phase: each issues its S
//    only once the other's S has completed (two named barriers, each WG
//    arriving on the other's), so one WG's softmax runs while the other's
//    products are on the tensor cores.
// As in psd_tpu's kernel, the denominator sums the bf16-rounded
// probabilities that enter P·V, logits are scaled by scale·log2(e) in fp32
// and exponentiated with exp2, and `lse` (when not null) gets m + log2(l)
// per row, fp32 (B, H, Sq), for attention_bwd.cu.
// Requires D % 8 == 0, Sq % 128 == 0 and Sk % kBK == 0 (the wrapper checks
// Sk % 128).
#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace {

using namespace hopper;

constexpr int kBQ = 128;  // query rows a block: 64 for each consumer WG

// 2^x on the SFU: one MUFU.EX2 (ex2.approx.ftz; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tiling for a padded head dim: blocks an SM, threads (two consumer WGs,
// then a producer warp or WG), key tile, ring depth and the shared memory
// they take (q + kStages × (K + V) + barriers + alignment slack, within the
// 227 KB an SM's blocks may have).
template <int DP>
struct Narrow {
  static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;
  static constexpr int kThreads = kBlocksPerSM == 2 ? 288 : 384;  // consumers first
  static constexpr int kBoxes = (DP + 63) / 64;
  static constexpr int kBK = kBlocksPerSM == 2 ? 64 : (DP <= 128 ? 128 : 64);
  static constexpr int kStages = kBlocksPerSM == 2 ? 4 : (DP <= 128 ? 2 : 3);
  static constexpr uint32_t kQBytes = kBQ * kBoxes * 128;
  static constexpr uint32_t kTileBytes = kBK * kBoxes * 128;  // one K or one V tile
  static constexpr uint32_t kOffKV = kQBytes;  // stage s: K at kOffKV + s·2·kTileBytes, V after
  static constexpr uint32_t kOffBar = kOffKV + kStages * 2 * kTileBytes;
  static constexpr size_t kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(DP % 16 == 0 && DP <= 160, "narrow path: Dp <= 160");
  static_assert(kSmemBytes * kBlocksPerSM <= 232448, "shared memory");
};

template <int DP>
__global__ void __launch_bounds__(Narrow<DP>::kThreads, Narrow<DP>::kBlocksPerSM)
narrow_attention_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                        float* __restrict__ lse, int Sq, int Sk, int H, int D,
                        float scale_log2) {
  using T = Narrow<DP>;
  constexpr int BK = T::kBK, NB = T::kBoxes, ST = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::kOffBar);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = Sk / BK;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    if constexpr (T::kBlocksPerSM == 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      mbar_arrive_expect_tx(qbar, T::kQBytes);
      for (int c = 0; c < NB; ++c)
        tma_load_3d(smem + c * kBQ * 128, &tq, qbar, c * 64, h, b * Sq + q0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], ((t / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);
        unsigned char* ks = smem + T::kOffKV + s * 2 * T::kTileBytes;
        const int row = b * Sk + t * BK;
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(ks + c * BK * 128, &tk, &full[s], c * 64, h, row);
          tma_load_3d(ks + T::kTileBytes + c * BK * 128, &tv, &full[s], c * 64, h, row);
        }
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (T::kBlocksPerSM == 1) setmaxnreg_inc<240>();
    const int c = wg;  // query rows q0 + 64c .. q0 + 64c + 63
    const int wid = threadIdx.x % 128, warp = wid / 32, lane = wid % 32;
    const int g = lane >> 2, tig = lane & 3;
    // this WG's 64 rows of each q box start 64 rows (8 KB, whole swizzle atoms) in
    const uint32_t qs = smem_addr(smem) + c * 64 * 128;

    float o[DP / 2];  // m64nDp accumulator: o[4n + e], columns 8n + 2·tig (+1)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // The consumer WGs take turns: WG c issues S only once the other WG's S
    // has completed (named barrier 1 + c, which the other WG arrives on), so
    // one WG's softmax and P·V run while the other's S is on the tensor
    // cores. WG 0 goes first.
    if (c == 1) named_arrive(1, 256);
    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      named_sync(1 + c, 256);
      const uint32_t kst = smem_addr(smem) + T::kOffKV + s * 2 * T::kTileBytes;
      const uint32_t vst = kst + T::kTileBytes;

      // S = q·kᵀ (64 × BK): Dp/16 steps of k16, q and K both K-major; a k16
      // step moves 32 B inside a 64-column box
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t box = ks >> 2, in_box = (ks & 3) * 32;
        wgmma_ss<BK>(sc, wgmma_desc(qs + box * (kBQ * 128) + in_box, 16, 1024),
                     wgmma_desc(kst + box * (BK * 128) + in_box, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);
      if (c == 0 || t + 1 < n_tiles) named_arrive(2 - c, 256);  // the other WG's turn

      // online softmax; rows 16·warp + g (e = 0, 1) and + 8 (e = 2, 3)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[BK / 16][4];  // P in the A fragment of m64k16: keys 16kk + (0..15)
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16x2_sum(
            ex2(sc[4 * j] * scale_log2 - mn0), ex2(sc[4 * j + 1] * scale_log2 - mn0), ls0);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2_sum(
            ex2(sc[4 * j + 2] * scale_log2 - mn1), ex2(sc[4 * j + 3] * scale_log2 - mn1), ls1);
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }

      // O += P · V_tile: V is MN-major (d contiguous); the leading offset
      // steps one 64-column box (BK rows · 128 B), the stride offset 8 keys
      // (1024 B); a k16 step is 16 key rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_tb<DP>(o, pa[kk], wgmma_desc(vst + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int row = q0 + 64 * c + 16 * warp + g;
    const size_t row_stride = static_cast<size_t>(H) * D;
    bf16* r0 = out + (static_cast<size_t>(b) * Sq + row) * row_stride + static_cast<size_t>(h) * D;
    bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (n * 8 < D) {
        *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
            __floats2bfloat162_rn(o[4 * n] * i0, o[4 * n + 1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
    }
    if (lse != nullptr && tig == 0) {
      float* lr = lse + static_cast<size_t>(bh) * Sq + row;
      lr[0] = m0 + log2f(l0);
      lr[8] = m1 + log2f(l1);
    }
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int B,
                   int Sq, int Sk, int H, int D, float scale_log2, cudaStream_t st) {
  using T = Narrow<DP>;
  if (Sq % kBQ != 0 || Sk % T::kBK != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!bf16_rows_map(&tq, q, B * Sq, H, D, kBQ) || !bf16_rows_map(&tk, k, B * Sk, H, D, T::kBK) ||
      !bf16_rows_map(&tv, v, B * Sk, H, D, T::kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(narrow_attention_kernel<DP>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  narrow_attention_kernel<DP><<<dim3(Sq / kBQ, B * H), T::kThreads, T::kSmemBytes, st>>>(
      tq, tk, tv, out, lse, Sq, Sk, H, D, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The padded head dims the kernel is built for; a D between two of them is
// zero-filled up to the next by TMA.
cudaError_t launch_narrow_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                    float* lse, int B, int Sq, int Sk, int H, int D,
                                    float scale_log2, cudaStream_t st) {
  const int dp = (D + 15) / 16 * 16;
  if (dp <= 32) return launch<32>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 48) return launch<48>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 64) return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 80) return launch<80>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 96) return launch<96>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 128) return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  if (dp <= 160) return launch<160>(q, k, v, out, lse, B, Sq, Sk, H, D, scale_log2, st);
  return cudaErrorInvalidValue;
}

}  // namespace psd
