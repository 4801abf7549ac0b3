// attention_q8_fwd: int8 spatial attention, the counterpart of
// psd_tpu/ops/spattn.py::_kernel_q8 (reached through
// spatial_attention(quant="qk8" | "int8")).
//
// Inputs arrive quantized by the plain-torch pre-pass (ops/attention.py
// quantize_qkv): qq, kq int8 (B·H, S, Dp) with D zero-padded to Dp =
// ceil32(D); sq, sk fp32 (B·H, S) row scales; and
//  * "qk8": v bf16 (B, S, H, D) as the model holds it;
//  * "int8": vq int8 (B·H, Dp, S), key-major, with sv fp32 (B·H, Dp)
//    column scales over S; within each 32-key chunk the keys are placed
//    where the P·V product's A fragment wants them (below;
//    ops/attention.py q8_place_keys).
// Output bf16 (B, S, H, D). Per query row (log2 units, c = scale·log2e):
//   x = (acc·(sq·c))·sk,  m = max x,  p = exp2(x − m),  l = Σp (fp32)
//   "qk8":  out = (Σ bf16(p)·v) / l
//   "int8": pn = p/l, ps = max(max pn, 1e-20)/127 (max pn = 1/l: the row
//           max contributes exp2(0) = 1), pq = rint(pn/ps) (half to even),
//           out = ((Σ pq·vq)·ps)·sv.
//
// What bounds it on the H100. At (8, 4096, 8, 40) the function is 86 G
// int8 ops (QKᵀ) + 86 G bf16 or int8 ops (P·V) against 11 MB of operands:
// 0.13 / 0.09 ms at the tensor cores' peak. Every logit also takes one exp2
// on the SFU (16 a clock on each SM; 1.07 G logits, ≈ 0.26 ms) in "qk8"
// and two in "int8", and ~12 ("qk8") to ~22 ("int8") other instructions
// on the CUDA cores, which issue 128 a clock on each SM. So the issue of
// the per-logit work and the waits between it and the products, not the
// tensor cores, set the time; the design keeps the products on the tensor
// cores and the instructions a logit few:
//  * One block per (128 query rows, b·h): two consumer warpgroups of 64
//    rows each, then a producer (one thread issues TMA loads: q once, then
//    K and sk tiles of 128 keys, and V tiles in the P·V pass, into a ring
//    of kStages, each completed on its stage's full mbarrier and released
//    on its empty one, as in attention_narrow.cu). Two blocks an SM at
//    Dp ≤ 64 (at most 112 registers a thread; ptxas takes 96), one above
//    (setmaxnreg 24 / 240; one block an SM at Dp ≤ 64 measured 30% slower).
//  * Shared memory holds every int8 tile as 128-byte swizzled rows: q and
//    K rows of Dp bytes arrive in boxes of 128 columns whose columns past
//    Dp TMA fills with zeros (64-byte rows in 64B swizzle at Dp ≤ 64
//    measured no faster); a Vᵀ row is a tile's 128 keys.
//  * QKᵀ on s8 wgmma m64n64k32, both operands K-major from shared memory,
//    s32 accumulators, for each 64-key half of a tile (Dp/32 steps). In
//    pass 1, where O is not live yet, both halves' products are issued at
//    once and the second runs under the first half's work (8% faster at
//    D = 40; issued so in pass 2, beside O, ptxas serializes the wgmma at
//    Dp ≤ 64). The consumer warpgroups run freely (taking turns at the
//    products, as attention_narrow.cu's do, measured 2–4% slower).
//  * Passes over the keys, one loop each. The TPU kernel keeps a whole
//    logit row resident and takes the exact softmax once; here a row is
//    streamed twice.
//    "qk8": pass 1 keeps only each lane's running max (no exp2); pass 2
//    forms p against the final m (the row's max, bit for bit x.amax()),
//    sums l and runs P·V. "int8" quantizes p with ps, which needs the final
//    l before its first P·V product: pass 1 keeps each lane's online (m, l),
//    merged across the row's 4 lanes at its end; pass 2 forms p, pn, pq
//    and runs P·V (three passes, the max, then l against it, measured
//    slower: a third QKᵀ sweep costs more than the online rescale).
//  * "qk8" P·V on bf16 wgmma m64nDpk16: P packed to bf16 straight from the
//    accumulator, which is the A register fragment; B = V MN-major through
//    the 3-D (D, H, B·S) map, columns past D zero-filled.
//  * "int8" P·V on s8 wgmma m64nDpk32 with A from registers. The s8 A
//    fragment holds 4 consecutive k per register, the accumulator pairs of
//    columns; instead of moving bytes between lanes, vq's keys are placed
//    within each 32-key chunk so that logical k = 4·tig + e holds key
//    2·tig + {0, 1, 8, 9}[e] (+16 in a[2], a[3]), exactly what thread tig
//    holds in the accumulator. B = that Vᵀ tile, K-major (keys contiguous).
//  * Per-logit arithmetic in as few instructions as measured fastest,
//    bit-exact against the plain version: the two divisions p/l and pn/ps
//    by Markstein's correction from one correctly rounded reciprocal a row
//    (div_rn: three full-rate instructions each in place of IEEE division's
//    reciprocal and refinement); rint as + 1.5·2²³, whose low byte is pq;
//    int32 → fp32 by I2F (one instruction; the add trick, two full-rate
//    ones, measured 3–5% slower); exp2 as one ex2.approx.ftz. The dequant
//    multiplies are __fmul_rn so nothing contracts them into an FMA: the
//    fp32 values that decide p and pq are the plain version's.
// Requires D % 8 == 0, Dp ≤ 256, S % 128 == 0 (the wrapper checks
// q8_shape_error).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace {

using namespace hopper;

constexpr int kQ8BQ = 128;  // query rows a block: 64 for each consumer WG
constexpr int kQ8BK = 128;  // keys a tile: one 128-byte row of the int8 Vᵀ tile
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kMagic = 12582912.0f;  // 1.5·2^23: integers |n| < 2^22 in the low mantissa

// Tiling for a padded head dim and mode: blocks an SM, threads (two
// consumer WGs, then a producer warp or WG), ring depth and the shared
// memory they take (q, kStages × (K, V), kStages × sk, barriers, alignment
// slack), within what one or two blocks an SM may have.
template <int DP, bool PV8>
struct Q8 {
  static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;
  static constexpr int kThreads = kBlocksPerSM == 2 ? 288 : 384;  // consumers first
  static constexpr int kKBoxes = (DP + 127) / 128;  // 128-byte boxes of a q or K row
  static constexpr int kVBoxes = (DP + 63) / 64;    // 64-column bf16 boxes of a V row ("qk8")
  static constexpr uint32_t kQBytes = kQ8BQ * kKBoxes * 128;
  static constexpr uint32_t kKBytes = kQ8BK * kKBoxes * 128;
  static constexpr uint32_t kVBytes = PV8 ? DP * 128 : kQ8BK * kVBoxes * 128;
  static constexpr uint32_t kSkBytes = kQ8BK * 4;
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;  // whole swizzle atoms
  static constexpr size_t kLimit = kBlocksPerSM == 2 ? 115712 : 232448;
  // a stage: K, V, sk and two barriers
  static constexpr size_t kPerStage = kStageBytes + kSkBytes + 16;
  static constexpr size_t kFixed = kQBytes + 8 + 1024;  // q, its barrier, alignment slack
  static constexpr int kStages = kFixed + 4 * kPerStage <= kLimit   ? 4
                                 : kFixed + 3 * kPerStage <= kLimit ? 3
                                                                    : 2;
  static constexpr uint32_t kOffStage = kQBytes;  // stage s: K at kOffStage + s·kStageBytes, V after
  static constexpr uint32_t kOffSk = kOffStage + kStages * kStageBytes;
  static constexpr uint32_t kOffBar = kOffSk + kStages * kSkBytes;
  static constexpr size_t kSmemBytes = kFixed + kStages * kPerStage;
  static_assert(DP % 32 == 0 && DP <= 256, "Dp = ceil32(D) <= 256");
  static_assert(kSmemBytes <= kLimit, "shared memory");
};

// 2^x on the SFU: one MUFU.EX2 (ex2.approx.ftz), torch.exp2's (exp2f's)
// result wherever that is a normal number; below 2^-126 it is 0, which
// changes no l (≥ 1) and no pq (0 either way)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (acc·rq)·sk in fp32 (acc exact: |acc| ≤ 127²·256 < 2^24)
__device__ __forceinline__ float dequant(int acc, float rq, float s) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), rq), s);
}

// x/d correctly rounded, given r = __frcp_rn(d) (Markstein: q0 within an
// ulp of x/d and its exact residual e give the correctly rounded quotient)
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);
}

// round(pn/ps) half to even: the bits of y + 1.5·2^23, whose low byte is
// the integer (0 <= y < 2^22)
__device__ __forceinline__ uint32_t quantize(float p, float l, float rl, float ps, float rps) {
  return __float_as_uint(__fadd_rn(div_rn(div_rn(p, l, rl), ps, rps), kMagic));
}

// the low bytes of four words, a in byte 0
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <int DP, bool PV8>
__global__ void __launch_bounds__(Q8<DP, PV8>::kThreads, Q8<DP, PV8>::kBlocksPerSM)
q8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const float* __restrict__ sq,
          const float* __restrict__ sk, const float* __restrict__ sv, bf16* __restrict__ out,
          int S, int H, int D, float c_log2) {
  using T = Q8<DP, PV8>;
  constexpr int ST = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::kOffBar);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;
  float* sks = reinterpret_cast<float*>(smem + T::kOffSk);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kQ8BQ;
  const int n_tiles = S / kQ8BK;
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
      for (int x = 0; x < T::kKBoxes; ++x)
        tma_load_2d(smem + x * kQ8BQ * 128, &tq, qbar, x * 128, bh * S + q0);
      for (int t = 0; t < 2 * n_tiles; ++t) {  // two passes over the keys
        const int s = t % ST, k0 = (t % n_tiles) * kQ8BK;
        const bool pv = t >= n_tiles;
        if (t >= ST) mbar_wait(&empty[s], ((t / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], T::kKBytes + T::kSkBytes + (pv ? T::kVBytes : 0));
        unsigned char* ks = smem + T::kOffStage + s * T::kStageBytes;
        for (int x = 0; x < T::kKBoxes; ++x)
          tma_load_2d(ks + x * kQ8BK * 128, &tk, &full[s], x * 128, bh * S + k0);
        bulk_load(sks + s * kQ8BK, sk + static_cast<size_t>(bh) * S + k0, T::kSkBytes, &full[s]);
        if (pv) {
          unsigned char* vs = ks + T::kKBytes;
          if constexpr (PV8) {
            tma_load_2d(vs, &tv, &full[s], k0, bh * DP);
          } else {
            for (int x = 0; x < T::kVBoxes; ++x)
              tma_load_3d(vs + x * kQ8BK * 128, &tv, &full[s], x * 64, h, b * S + k0);
          }
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
    const int row = q0 + 64 * c + 16 * warp + g;
    const size_t srow = static_cast<size_t>(bh) * S + row;
    const float rq0 = __fmul_rn(sq[srow], c_log2), rq1 = __fmul_rn(sq[srow + 8], c_log2);

    // each lane's statistics over its own columns until a pass ends, then
    // the row's (the 4 lanes of a row merged)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float rl0 = 0.f, rl1 = 0.f, ps0 = 0.f, ps1 = 0.f, rps0 = 0.f, rps1 = 0.f;

    // S = q·kᵀ (64 × 64) of the tile in stage s, 64-key half hh: Dp/32
    // steps of k32, both K-major (a k32 step moves 32 B inside a 128-byte
    // box), one commit group; then, once it has completed, x in log2 units:
    // rows 16·warp + g (e = 0, 1) and + 8 (e = 2, 3), keys 64·hh + 8j +
    // 2·tig (+1)
    auto issue_s = [&](int s, int hh, int (&acc)[32]) {
      const uint32_t kst = smem_addr(smem) + T::kOffStage + s * T::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 32; ++ks) {
        const uint32_t box = ks >> 2, in_box = (ks & 3) * 32;
        wgmma_ss_s8<64>(acc, wgmma_desc(qs + box * (kQ8BQ * 128) + in_box, 16, 1024),
                        wgmma_desc(kst + box * (kQ8BK * 128) + hh * 64 * 128 + in_box, 16, 1024),
                        ks > 0);
      }
      wgmma_commit();
    };
    auto dequant_s = [&](int s, int hh, int (&acc)[32], float (&x)[32]) {
      const float* skc = sks + s * kQ8BK;
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(skc + hh * 64 + 8 * j + 2 * tig);
        x[4 * j] = dequant(acc[4 * j], rq0, s2.x);
        x[4 * j + 1] = dequant(acc[4 * j + 1], rq0, s2.y);
        x[4 * j + 2] = dequant(acc[4 * j + 2], rq1, s2.x);
        x[4 * j + 3] = dequant(acc[4 * j + 3], rq1, s2.y);
      }
    };

    mbar_wait(qbar, 0);
    // pass 1: this lane's statistics over its own columns; both halves'
    // products issued at once, the second under the first half's work (o
    // is not live yet, so the two accumulators fit)
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      int acc[2][32];
      issue_s(s, 0, acc[0]);
      issue_s(s, 1, acc[1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x[32];
        if (hh == 0) wgmma_wait<1>(); else wgmma_wait<0>();
        dequant_s(s, hh, acc[hh], x);
        if (PV8) {  // online max and sum
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(x[4 * j], x[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(x[4 * j + 2], x[4 * j + 3]));
          }
          float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ls0 += ex2(x[4 * j] - mx0) + ex2(x[4 * j + 1] - mx0);
            ls1 += ex2(x[4 * j + 2] - mx1) + ex2(x[4 * j + 3] - mx1);
          }
          l0 = l0 * ex2(m0 - mx0) + ls0;
          l1 = l1 * ex2(m1 - mx1) + ls1;
          m0 = mx0;
          m1 = mx1;
        } else {  // the max alone
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            m0 = fmaxf(m0, fmaxf(x[4 * j], x[4 * j + 1]));
            m1 = fmaxf(m1, fmaxf(x[4 * j + 2], x[4 * j + 3]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the row max (and, "int8", its sum) over the row's 4 lanes
    float mr0 = m0, mr1 = m1;
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mr0 = fmaxf(mr0, __shfl_xor_sync(0xffffffffu, mr0, o_));
      mr1 = fmaxf(mr1, __shfl_xor_sync(0xffffffffu, mr1, o_));
    }
    if constexpr (PV8) {
      l0 *= ex2(m0 - mr0);
      l1 *= ex2(m1 - mr1);
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      // ps and the reciprocals the divisions take
      rl0 = __frcp_rn(l0);
      rl1 = __frcp_rn(l1);
      ps0 = __fmul_rn(fmaxf(rl0, 1e-20f), kInv127);
      ps1 = __fmul_rn(fmaxf(rl1, 1e-20f), kInv127);
      rps0 = __frcp_rn(ps0);
      rps1 = __frcp_rn(ps1);
    }
    m0 = mr0;
    m1 = mr1;

    // pass 2: p against the final max, and P·V into the m64nDp accumulator
    // o[4n + e] (columns 8n + 2·tig (+1), rows g, g + 8), live from here on
    using Acc = typename std::conditional<PV8, int, float>::type;
    Acc o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0;
    for (int t = n_tiles; t < 2 * n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      const uint32_t vst = smem_addr(smem) + T::kOffStage + s * T::kStageBytes + T::kKBytes;
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        int acc[32];
        float x[32];
        issue_s(s, hh, acc);
        wgmma_wait<0>();
        dequant_s(s, hh, acc, x);
        if constexpr (PV8) {
          // pq packed as the s8 A fragment of each 32-key chunk: logical
          // k = 4·tig + e ↔ key 2·tig + {0, 1, 8, 9}[e] (+16 in a[2], a[3])
          uint32_t pa[2][4];
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            uint32_t w[4][4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * ch + jj;
              w[jj][0] = quantize(ex2(x[4 * j] - m0), l0, rl0, ps0, rps0);
              w[jj][1] = quantize(ex2(x[4 * j + 1] - m0), l0, rl0, ps0, rps0);
              w[jj][2] = quantize(ex2(x[4 * j + 2] - m1), l1, rl1, ps1, rps1);
              w[jj][3] = quantize(ex2(x[4 * j + 3] - m1), l1, rl1, ps1, rps1);
            }
            pa[ch][0] = low_bytes(w[0][0], w[0][1], w[1][0], w[1][1]);
            pa[ch][1] = low_bytes(w[0][2], w[0][3], w[1][2], w[1][3]);
            pa[ch][2] = low_bytes(w[2][0], w[2][1], w[3][0], w[3][1]);
            pa[ch][3] = low_bytes(w[2][2], w[2][3], w[3][2], w[3][3]);
          }
          // O += Pq · Vq_half: B K-major, 128-byte rows of keys; a k32 step
          // is 32 keys (bytes) of the row
          wgmma_fence();
#pragma unroll
          for (int ch = 0; ch < 2; ++ch)
            wgmma_rs_s8<DP>(o, pa[ch], wgmma_desc(vst + (2 * hh + ch) * 32, 16, 1024), 1);
        } else {
          uint32_t pa[4][4];  // bf16(p) in the A fragment of m64k16: keys 16kk + (0..15)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float p0 = ex2(x[4 * j] - m0), p1 = ex2(x[4 * j + 1] - m0);
            const float p2 = ex2(x[4 * j + 2] - m1), p3 = ex2(x[4 * j + 3] - m1);
            l0 += p0 + p1;
            l1 += p2 + p3;
            pa[j / 2][(j % 2) * 2] = pack_bf16x2(p0, p1);
            pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2, p3);
          }
          // O += P · V_half: V MN-major (d contiguous); the leading offset
          // steps one 64-column box (128 rows · 128 B), the stride offset 8
          // keys (1024 B); a k16 step is 16 key rows
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_tb<DP>(o, pa[kk],
                            wgmma_desc(vst + (hh * 64 + kk * 16) * 128, kQ8BK * 128, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    if constexpr (!PV8) {
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
    }
    const size_t row_stride = static_cast<size_t>(H) * D;
    bf16* r0 = out + (static_cast<size_t>(b) * S + row) * row_stride + static_cast<size_t>(h) * D;
    bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (n * 8 < D) {
        float v00, v01, v10, v11;
        if constexpr (PV8) {
          const float2 s2 = *reinterpret_cast<const float2*>(sv + static_cast<size_t>(bh) * DP + col);
          v00 = __fmul_rn(__fmul_rn(__int2float_rn(o[4 * n]), ps0), s2.x);
          v01 = __fmul_rn(__fmul_rn(__int2float_rn(o[4 * n + 1]), ps0), s2.y);
          v10 = __fmul_rn(__fmul_rn(__int2float_rn(o[4 * n + 2]), ps1), s2.x);
          v11 = __fmul_rn(__fmul_rn(__int2float_rn(o[4 * n + 3]), ps1), s2.y);
        } else {
          v00 = o[4 * n] / l0;
          v01 = o[4 * n + 1] / l0;
          v10 = o[4 * n + 2] / l1;
          v11 = o[4 * n + 3] / l1;
        }
        *reinterpret_cast<__nv_bfloat162*>(r0 + col) = __floats2bfloat162_rn(v00, v01);
        *reinterpret_cast<__nv_bfloat162*>(r1 + col) = __floats2bfloat162_rn(v10, v11);
      }
    }
  }
}

template <int DP, bool PV8>
cudaError_t launch_q8(const void* qq, const float* sq, const void* kq, const float* sk,
                      const void* v, const float* sv, bf16* out, int B, int S, int H, int D,
                      float c, cudaStream_t st) {
  using T = Q8<DP, PV8>;
  CUtensorMap tq, tk, tv;
  const int rows = B * H * S;
  if (!s8_rows_map(&tq, qq, rows, DP, kQ8BQ) || !s8_rows_map(&tk, kq, rows, DP, kQ8BK))
    return cudaErrorInvalidValue;
  if (PV8 ? !s8_rows_map(&tv, v, B * H * DP, S, DP) : !bf16_rows_map(&tv, v, B * S, H, D, kQ8BK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(q8_kernel<DP, PV8>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  q8_kernel<DP, PV8><<<dim3(S / kQ8BQ, B * H), T::kThreads, T::kSmemBytes, st>>>(
      tq, tk, tv, sq, sk, sv, out, S, H, D, c);
  return cudaGetLastError();
}

template <bool PV8>
cudaError_t dispatch_q8(int DP, const void* qq, const float* sq, const void* kq,
                        const float* sk, const void* v, const float* sv, bf16* out, int B,
                        int S, int H, int D, float c, cudaStream_t st) {
  switch (DP) {
    case 32: return launch_q8<32, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 64: return launch_q8<64, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 96: return launch_q8<96, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 128: return launch_q8<128, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 160: return launch_q8<160, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 192: return launch_q8<192, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 224: return launch_q8<224, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    case 256: return launch_q8<256, PV8>(qq, sq, kq, sk, v, sv, out, B, S, H, D, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace psd

extern "C" int psd_attention_q8_fwd(const void* qq, const void* sq, const void* kq,
                                    const void* sk, const void* v, const void* sv, void* out,
                                    int B, int S, int H, int D, float scale_log2, int pv8,
                                    void* stream) {
  using namespace psd;
  if (D % 8 != 0 || D <= 0 || S % kQ8BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 31) / 32 * 32;
  const float* sqp = static_cast<const float*>(sq);
  const float* skp = static_cast<const float*>(sk);
  const float* svp = static_cast<const float*>(sv);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pv8 ? dispatch_q8<true>(dp, qq, sqp, kq, skp, v, svp, op, B, S, H, D, scale_log2, st)
          : dispatch_q8<false>(dp, qq, sqp, kq, skp, v, svp, op, B, S, H, D, scale_log2, st);
  return static_cast<int>(err);
}
