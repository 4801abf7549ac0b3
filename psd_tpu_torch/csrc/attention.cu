// attention_fwd: non-causal softmax(q·kᵀ·scale)·v, (B, S, H, D) bf16 in and
// out, fp32 logits and accumulators.
//
// Replaces psd_tpu/ops/spattn.py::_kernel (UNet self-attention, D = 40/80
// at S = 4096/1024) and the forward of JAX's stock Pallas flash kernel that
// psd_tpu/ops/flash.py::flash_attention wraps (the VAE mid-block: one head,
// D = 512, S = 4096).
//
// What bounds it on the H100. At (8, 4096, 8, 40) the two products are
// 4·B·H·S²·D ≈ 172 GFLOP (206 GFLOP at the padded D = 48) against 10 MB
// of q/k/v/out, so it is compute-bound; but the S² softmax elementwise work
// (≈1.1 G exp2 + max + sum) runs on the CUDA cores and costs as much as the
// tensor-core products at this small D. The Pallas kernel keeps a whole K/V
// row resident in VMEM and takes one exact softmax; a block here has 227 KB
// of shared memory, so K/V stream through in 64-row tiles with an online
// softmax (running max m and sum l per query row, the accumulator rescaled
// by exp2(m_old − m_new) before each tile's P·V).
//
// Two paths, chosen by the padded head dim Dp = ceil16(D):
//  * Dp ≤ 256 (the UNet's 40/80/160): flash_kernel<Dp>, here. One block of
//    4 warps per (64 query rows, b·h); each warp owns 16 rows. Logits, the
//    probabilities and the O accumulator stay in registers: mma.sync
//    m16n8k16 bf16 with fp32 accumulation, whose accumulator layout is the
//    A-operand layout of the next product, so P never touches shared memory.
//    Row max and sum reduce over the 4 lanes that share a row. K/V tiles
//    are double-buffered in shared memory with cp.async; V's B fragments
//    come through ldmatrix.trans. Zero columns pad D to Dp.
//  * Dp > 256 (the VAE's 512): launch_wide_attention in attention_wide.cu,
//    a warp-specialised kernel fed by TMA through an mbarrier ring (the
//    note there gives its design).
// In both, as in spattn, the denominator sums the bf16-rounded probabilities
// that enter P·V, so the output is a convex combination of v rows; logits
// are scaled by scale·log2(e) in fp32 and exponentiated with exp2.
// When `lse` is not null (training asks for it), each query row's
// log-sum-exp in log2 units, m + log2(l), is written as fp32 (B, H, Sq) for
// the backward kernel (attention_bwd.cu); serving passes null.
// Requires D % 8 == 0, Sq % 64 == 0, Sk % 64 == 0 (the wrapper checks).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace psd {
namespace {

constexpr int kFlashBQ = 64, kFlashBK = 64, kFlashWarps = 4;

inline size_t flash_smem(int dp) {
  return static_cast<size_t>(kFlashBQ + 4 * kFlashBK) * (dp + 8) * 2;
}

template <int DP>
__global__ void __launch_bounds__(32 * kFlashWarps)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
             int Sq, int Sk, int H, int D, float scale_log2) {
  constexpr int LD = DP + 8, NS = kFlashBK / 8, NO = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kFlashBQ * LD;         // [2][BK][LD]
  bf16* Vs = Ks + 2 * kFlashBK * LD;     // [2][BK][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFlashBQ;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_off = static_cast<size_t>(h) * D;

  load_rows(q + (static_cast<size_t>(b) * Sq + q0) * row_stride + head_off, row_stride,
            kFlashBQ, D, DP, Qs, LD);

  auto load_kv = [&](int tile, int buf) {
    const size_t base = (static_cast<size_t>(b) * Sk + tile * kFlashBK) * row_stride + head_off;
    bf16* kd = Ks + buf * kFlashBK * LD;
    bf16* vd = Vs + buf * kFlashBK * LD;
    for (int idx = threadIdx.x; idx < kFlashBK * (DP / 8); idx += blockDim.x) {
      const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
      if (c < D) {
        __pipeline_memcpy_async(kd + r * LD + c, k + base + r * row_stride + c, 16);
        __pipeline_memcpy_async(vd + r * LD + c, v + base + r * row_stride + c, 16);
      } else {
        *reinterpret_cast<uint4*>(kd + r * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + r * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    __pipeline_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const bf16* qw = Qs + (warp * 16 + g) * LD + tig * 2;

  const int n_tiles = Sk / kFlashBK;
  load_kv(0, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, cur ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* kc = Ks + cur * kFlashBK * LD;
    const bf16* vc = Vs + cur * kFlashBK * LD;

    // S = Q · K_tileᵀ, 16 × 64 per warp, in registers
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t a[4] = {ld_u32(qw + ks * 16), ld_u32(qw + 8 * LD + ks * 16),
                             ld_u32(qw + ks * 16 + 8), ld_u32(qw + 8 * LD + ks * 16 + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kp = kc + (j * 8 + g) * LD + ks * 16 + tig * 2;
        mma_bf16(s[j], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // online softmax; rows g (c0, c1) and g + 8 (c2, c3) of the warp's 16
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
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
    uint32_t pa[NS / 2][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16x2_sum(exp2f(s[j][0] * scale_log2 - mn0),
                                               exp2f(s[j][1] * scale_log2 - mn0), ls0);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2_sum(exp2f(s[j][2] * scale_log2 - mn1),
                                                   exp2f(s[j][3] * scale_log2 - mn1), ls1);
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P · V_tile
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const bf16* vrow = vc + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(o[n], pa[kk], b0, b1);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* r0 = out + (static_cast<size_t>(b) * Sq + q0 + warp * 16 + g) * row_stride + head_off;
  bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (n * 8 < D) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + c) = __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(r1 + c) = __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
    }
  }
  if (lse != nullptr && tig == 0) {
    float* lr = lse + static_cast<size_t>(bh) * Sq + q0 + warp * 16 + g;
    lr[0] = m0 + log2f(l0);
    lr[8] = m1 + log2f(l1);
  }
}

template <int DP>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                         int B, int Sq, int Sk, int H, int D, float scale_log2,
                         cudaStream_t st) {
  const size_t bytes = flash_smem(DP);
  cudaError_t err = allow_smem(flash_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_kernel<DP><<<dim3(Sq / kFlashBQ, B * H), 32 * kFlashWarps, bytes, st>>>(
      q, k, v, out, lse, Sq, Sk, H, D, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// attention_wide.cu: the Dp > 256 path
cudaError_t launch_wide_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                  float* lse, int B, int Sq, int Sk, int H, int D,
                                  float scale_log2, cudaStream_t st);

}  // namespace psd

extern "C" int psd_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int B, int Sq, int Sk, int H, int D, float scale,
                                 void* stream) {
  using namespace psd;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  switch ((D + 15) / 16 * 16) {
    case 32: return static_cast<int>(launch_flash<32>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 48: return static_cast<int>(launch_flash<48>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 64: return static_cast<int>(launch_flash<64>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 80: return static_cast<int>(launch_flash<80>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 96: return static_cast<int>(launch_flash<96>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 128: return static_cast<int>(launch_flash<128>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    case 160: return static_cast<int>(launch_flash<160>(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
    default: break;
  }
  return static_cast<int>(launch_wide_attention(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st));
}
