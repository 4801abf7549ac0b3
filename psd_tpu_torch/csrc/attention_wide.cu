// The attention forward for wide heads, 256 < Dp <= 512 (the VAE mid block:
// one head, D = 512, S = 4096): non-causal softmax(q·kᵀ·scale)·v, (B, S, H, D)
// bf16 in and out, fp32 logits and accumulators, the same function as
// flash_kernel in attention.cu.
//
// Replaces the forward of JAX's stock Pallas flash kernel
// (jax.experimental.pallas.ops.tpu.flash_attention), which
// psd_tpu/ops/flash.py:121 calls for the VAE mid block.
//
// What bounds it on the H100: operations. At (8, 4096, 1, 512) the two
// products are 4·B·H·S²·D = 275 GFLOP against 134 MB of q/k/v/out, 0.278 ms
// at 989 TFLOP/s. A 64-row query tile's fp32 accumulator is 64×512 floats,
// too wide for one warpgroup's registers, and a block may hold 227 KB of
// shared memory. The design:
//  * One block per (64 query rows, b·h), three warpgroups. WG0 is the
//    producer: one thread issues TMA loads (q once; then K and V tiles of 32
//    keys into a 2-stage ring, each completed on its stage's full mbarrier),
//    and the group gives its registers away (setmaxnreg 24). WG1 and WG2 are
//    the consumers (setmaxnreg 240): WG1 owns output columns 0-255, WG2
//    256-511, so each keeps a 64×256 fp32 accumulator in registers, 128 a
//    thread.
//  * Shared memory holds every tile as TMA wrote it, boxes of 64 columns
//    (128 B) with the 128-byte swizzle: q 64 KB, the ring 2 × (32 + 32) KB,
//    a 32 KB exchange buffer, the barriers: 225 KB.
//  * S = q·kᵀ (64×32, depth 512) is split over the depth: WG1 takes d < 256
//    and WG2 the rest, each with 16 wgmma m64n32k16 whose A (q) and B (K)
//    both come from shared memory, K-major. Each WG writes its partial to
//    the exchange buffer (in accumulator order, double-buffered by tile
//    parity), meets the other at a named barrier and adds the other's
//    partial. fp32 addition commutes, so both hold the same bits of S and
//    reach the same m, l and P.
//  * Online softmax in registers (row max and sum over the 4 lanes that
//    share a row); each WG rescales its own O half by exp2(m_old − m_new).
//  * P·V: P is packed to bf16 straight from the S accumulator, which is the
//    A register fragment of wgmma m64nNk16, and two wgmma m64n256k16 (one
//    per 16 keys) take it from registers with B = V[keys, this WG's 256
//    columns] from shared memory. V lies key-major, so B is MN-major
//    (transposed): the descriptor's leading offset steps one 64-column box
//    (32 rows · 128 B), its stride offset 8 keys (1024 B).
//  * Once wgmma.wait_group says P·V has read a stage, each consumer warp
//    arrives on the stage's empty mbarrier; the producer waits on it before
//    the refill.
//  * Not yet: the two consumer WGs meet at every tile's exchange, so the
//    tensor cores idle while both run the softmax; and each stage is read
//    by one CTA only (no cluster multicast of K/V).
// ptxas (sm_90a, -O3): 168 registers at entry (the bound for 384 threads),
// no spills, no stack; setmaxnreg then gives the producer WG 24 and the
// consumer WGs 240 each.
// As in flash_kernel, the denominator sums the bf16-rounded probabilities
// that enter P·V, logits are scaled by scale·log2(e) in fp32 and
// exponentiated with exp2, and `lse` (when not null) gets m + log2(l) per
// row. A D below 512 is zero-padded by TMA's out-of-bounds fill: the tensor
// maps are 3-D (D, H, B·S) with a box of 64 columns × one head.
// Requires D % 8 == 0, Sq % 64 == 0, Sk % 32 == 0 (the wrapper checks 64).
#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace {

using namespace hopper;

constexpr int kBQ = 64, kBK = 32, kDP = 512, kStages = 2, kBoxes = kDP / 64;
constexpr int kThreads = 384;  // producer WG + two consumer WGs
constexpr uint32_t kQBytes = kBQ * kDP * 2;    // 64 KB
constexpr uint32_t kKVBytes = kBK * kDP * 2;   // 32 KB each of a K and a V tile
constexpr int kXFloats = 128 * 16;             // one WG's S partial, fragment order
constexpr uint32_t kOffK = kQBytes;            // stage s: K at kOffK + s·2·kKVBytes, V after it
constexpr uint32_t kOffX = kOffK + kStages * 2 * kKVBytes;
constexpr uint32_t kOffBar = kOffX + 2 * 2 * kXFloats * 4;
constexpr size_t kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack

__global__ void __launch_bounds__(kThreads, 1)
wide_attention_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = Sk / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      mbar_arrive_expect_tx(qbar, kQBytes);
      for (int c = 0; c < kBoxes; ++c)
        tma_load_3d(smem + c * kBQ * 128, &tq, qbar, c * 64, h, b * Sq + q0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        unsigned char* ks = smem + kOffK + s * 2 * kKVBytes;
        const int row = b * Sk + t * kBK;
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(ks + c * kBK * 128, &tk, &full[s], c * 64, h, row);
          tma_load_3d(ks + kKVBytes + c * kBK * 128, &tv, &full[s], c * 64, h, row);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int c = wg - 1;  // output columns [256c, 256c + 256), depth half c of S
    const int wid = threadIdx.x % 128, warp = wid / 32, lane = wid % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int col0 = 256 * c;
    const uint32_t qs = smem_addr(smem);
    float* xbuf = reinterpret_cast<float*>(smem + kOffX) + wid;

    float o[128];  // m64n256 accumulator: o[4n + e], columns col0 + 8n + 2·tig (+1)
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t kst = qs + kOffK + s * 2 * kKVBytes, vst = kst + kKVBytes;

      // this WG's half of S = q·kᵀ (64 × 32): 16 steps of k16 over d in [col0, col0 + 256),
      // q and K both K-major; a k16 step moves 32 B inside a 64-column box
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        const uint32_t box = 4 * c + (ks >> 2), in_box = (ks & 3) * 32;
        wgmma_ss<32>(sc, wgmma_desc(qs + box * (kBQ * 128) + in_box, 16, 1024),
                     wgmma_desc(kst + box * (kBK * 128) + in_box, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i) reg_fence(sc[i]);

      // exchange the partials with the other consumer WG
      float* mine = xbuf + ((t & 1) * 2 + c) * kXFloats;
      const float* theirs = xbuf + ((t & 1) * 2 + (1 - c)) * kXFloats;
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i * 128] = sc[i];
      named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] += theirs[i * 128];

      // online softmax; rows 16·warp + g (e = 0, 1) and + 8 (e = 2, 3)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[2][4];  // P in the A fragment of m64k16: keys 16kk + (0..15)
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16x2_sum(
            exp2f(sc[4 * j] * scale_log2 - mn0), exp2f(sc[4 * j + 1] * scale_log2 - mn0), ls0);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2_sum(
            exp2f(sc[4 * j + 2] * scale_log2 - mn1), exp2f(sc[4 * j + 3] * scale_log2 - mn1), ls1);
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }

      // O[:, col0 : col0 + 256] += P · V_tile: V is MN-major (d contiguous);
      // the leading offset steps one 64-column box (kBK rows · 128 B), the
      // stride offset 8 keys (1024 B); a k16 step is 16 key rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t v_addr = vst + 4 * c * (kBK * 128) + kk * 16 * 128;
        wgmma_rs_tb<256>(o, pa[kk], wgmma_desc(v_addr, kBK * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) reg_fence(o[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const size_t row_stride = static_cast<size_t>(H) * D;
    bf16* r0 = out + (static_cast<size_t>(b) * Sq + q0 + warp * 16 + g) * row_stride +
               static_cast<size_t>(h) * D;
    bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int col = col0 + n * 8 + tig * 2;
      if (col0 + n * 8 < D) {
        *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
            __floats2bfloat162_rn(o[4 * n] * i0, o[4 * n + 1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
    }
    if (lse != nullptr && c == 0 && tig == 0) {
      float* lr = lse + static_cast<size_t>(bh) * Sq + q0 + warp * 16 + g;
      lr[0] = m0 + log2f(l0);
      lr[8] = m1 + log2f(l1);
    }
  }
}

}  // namespace

cudaError_t launch_wide_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                  float* lse, int B, int Sq, int Sk, int H, int D,
                                  float scale_log2, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!bf16_rows_map(&tq, q, B * Sq, H, D, kBQ) || !bf16_rows_map(&tk, k, B * Sk, H, D, kBK) ||
      !bf16_rows_map(&tv, v, B * Sk, H, D, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(wide_attention_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  wide_attention_kernel<<<dim3(Sq / kBQ, B * H), kThreads, kSmemBytes, st>>>(
      tq, tk, tv, out, lse, Sq, Sk, H, D, scale_log2);
  return cudaGetLastError();
}

}  // namespace psd
