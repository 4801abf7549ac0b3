// split3_fwd: gated triple-pathway cross-attention, (B, S, H, D) bf16.
//
//   out = g_anat·softmax(q·Kaᵀ·s)·Va + g_dis·softmax(q·Kdᵀ·s)·Vd
//       + δ·softmax(q·Kδᵀ·s)·Vδ
//
// Replaces psd_tpu/ops/split3.py::_kernel (every UNet cross-attention site
// with S ≥ 256 under split3 routing).
//
// What bounds it on the H100. Each bank holds 16 tokens, so per query row the
// work is 3·2·16·D multiply-adds for the logits and as many for P·V: at
// (8, 4096, 8, 40) that is 0.2 GFLOP against 2 × 21 MB of q in and out. It
// is bound by reading q and writing out (≈13 µs at 3.35 TB/s), not by math,
// as long as the per-row softmax work stays off the critical path: a first
// version that ran the logits and the gated sum on the CUDA cores, one query
// row per warp, took 0.6 ms there (PERF.md), latency-bound.
//
// Design: one block of 4 warps per (64 query rows, b·h), each warp 16 rows.
// The three banks are staged in shared memory as one 48-key tile (bank i at
// keys 16i.., short banks padded with masked keys). Logits for all three come
// from one mma.sync m16n8k16 product held in registers; each bank's 16-key
// slice gets its own exact softmax (max and sum over the 4 lanes sharing a
// row), normalized and scaled by its gate (g_anat, g_dis or δ) before
// rounding to bf16 — so the gated sum is ONE product P'·[Va; Vd; Vδ], with
// V's fragments from ldmatrix.trans. The Pallas kernel rounds p before the
// gate multiply; the difference is within bf16 rounding. q is read once and
// the output written once. The gates and δ are plain arguments: changing the
// steering scale rebuilds nothing.
// Requires bank lengths 1..16, D % 8 == 0, 24 ≤ D ≤ 160, S % 64 == 0 (the
// wrapper checks).
#include "common.cuh"

namespace psd {
namespace {

struct Split3Args {
  const bf16* bank[6];  // ka, va, kd, vd, kl, vl
  int len[3];
  float gate[3];
};

constexpr int kMmaRows = 64;

inline size_t mma_smem(int dp) { return static_cast<size_t>(kMmaRows + 96) * (dp + 8) * 2; }

template <int DP>
__global__ void __launch_bounds__(128)
mma_kernel(const bf16* __restrict__ q, bf16* __restrict__ out, Split3Args a, int S, int H,
           int D, float scale_log2) {
  constexpr int LD = DP + 8, NO = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* Ks = Qs + kMmaRows * LD;             // [48][LD]: bank i at rows 16i..
  bf16* Vs = Ks + 48 * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int s0 = blockIdx.x * kMmaRows;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_off = static_cast<size_t>(h) * D;

  load_rows(q + (static_cast<size_t>(b) * S + s0) * row_stride + head_off, row_stride,
            kMmaRows, D, DP, Qs, LD);
  for (int i = 0; i < 3; ++i) {
    const int L = a.len[i];
    const size_t off = static_cast<size_t>(b) * L * row_stride + head_off;
    load_rows(a.bank[2 * i] + off, row_stride, L, D, DP, Ks + 16 * i * LD, LD);
    load_rows(a.bank[2 * i + 1] + off, row_stride, L, D, DP, Vs + 16 * i * LD, LD);
    for (int idx = threadIdx.x; idx < (16 - L) * (DP / 8); idx += blockDim.x) {
      const int r = 16 * i + L + idx / (DP / 8), c = (idx % (DP / 8)) * 8;
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // logits against all 48 keys: n-tiles 2i, 2i+1 belong to bank i
  float s[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const bf16* qw = Qs + (warp * 16 + g) * LD + tig * 2;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t af[4] = {ld_u32(qw + ks * 16), ld_u32(qw + 8 * LD + ks * 16),
                            ld_u32(qw + ks * 16 + 8), ld_u32(qw + 8 * LD + ks * 16 + 8)};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const bf16* kp = Ks + (j * 8 + g) * LD + ks * 16 + tig * 2;
      mma_bf16(s[j], af, ld_u32(kp), ld_u32(kp + 8));
    }
  }

  // per bank: exact softmax over its keys, scaled by its gate, as A fragments
  uint32_t pa[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int L = a.len[i];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* sj = s[2 * i + t];
        if (t * 8 + tig * 2 + e >= L) sj[e] = sj[2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, sj[e]);
        mx1 = fmaxf(mx1, sj[2 + e]);
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* sj = s[2 * i + t];
        sj[e] = exp2f((sj[e] - mx0) * scale_log2);
        sj[2 + e] = exp2f((sj[2 + e] - mx1) * scale_log2);
        sum0 += sj[e];
        sum1 += sj[2 + e];
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    const float f0 = a.gate[i] / sum0, f1 = a.gate[i] / sum1;
    pa[i][0] = pack_bf16x2(s[2 * i][0] * f0, s[2 * i][1] * f0);
    pa[i][1] = pack_bf16x2(s[2 * i][2] * f1, s[2 * i][3] * f1);
    pa[i][2] = pack_bf16x2(s[2 * i + 1][0] * f0, s[2 * i + 1][1] * f0);
    pa[i][3] = pack_bf16x2(s[2 * i + 1][2] * f1, s[2 * i + 1][3] * f1);
  }

  // out = [g_a·P_a | g_d·P_d | δ·P_δ] · [Va; Vd; Vδ]
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const bf16* vrow = Vs + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, vrow + n * 8);
      mma_bf16(o[n], pa[kk], b0, b1);
    }
  }
  bf16* r0 = out + (static_cast<size_t>(b) * S + s0 + warp * 16 + g) * row_stride + head_off;
  bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < D) {
      const int c = n * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(r0 + c) = __floats2bfloat162_rn(o[n][0], o[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(r1 + c) = __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const bf16* q, bf16* out, const Split3Args& a, int B, int S, int H,
                       int D, float scale, cudaStream_t st) {
  const size_t bytes = mma_smem(DP);
  cudaError_t err = allow_smem(mma_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  mma_kernel<DP><<<dim3(S / kMmaRows, B * H), 128, bytes, st>>>(q, out, a, S, H, D,
                                                                 scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace psd

extern "C" int psd_split3_fwd(const void* q, const void* ka, const void* va,
                              const void* kd, const void* vd, const void* kl,
                              const void* vl, void* out, int B, int S, int H, int D,
                              int Ka, int Kd, int Kl, float g_anat, float g_dis,
                              float delta, float scale, void* stream) {
  using namespace psd;
  Split3Args a;
  const void* banks[6] = {ka, va, kd, vd, kl, vl};
  for (int i = 0; i < 6; ++i) a.bank[i] = static_cast<const bf16*>(banks[i]);
  a.len[0] = Ka;
  a.len[1] = Kd;
  a.len[2] = Kl;
  a.gate[0] = g_anat;
  a.gate[1] = g_dis;
  a.gate[2] = delta;
  const bf16* qp = static_cast<const bf16*>(q);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 32: return static_cast<int>(launch_mma<32>(qp, op, a, B, S, H, D, scale, st));
    case 48: return static_cast<int>(launch_mma<48>(qp, op, a, B, S, H, D, scale, st));
    case 64: return static_cast<int>(launch_mma<64>(qp, op, a, B, S, H, D, scale, st));
    case 80: return static_cast<int>(launch_mma<80>(qp, op, a, B, S, H, D, scale, st));
    case 96: return static_cast<int>(launch_mma<96>(qp, op, a, B, S, H, D, scale, st));
    case 112: return static_cast<int>(launch_mma<112>(qp, op, a, B, S, H, D, scale, st));
    case 128: return static_cast<int>(launch_mma<128>(qp, op, a, B, S, H, D, scale, st));
    case 144: return static_cast<int>(launch_mma<144>(qp, op, a, B, S, H, D, scale, st));
    case 160: return static_cast<int>(launch_mma<160>(qp, op, a, B, S, H, D, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
