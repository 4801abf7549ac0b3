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
//  * Dp ≤ 256 (the UNet's 40/80/160): flash_kernel<Dp>. One block of 4
//    warps per (64 query rows, b·h); each warp owns 16 rows. Logits, the
//    probabilities and the O accumulator stay in registers: mma.sync
//    m16n8k16 bf16 with fp32 accumulation, whose accumulator layout is the
//    A-operand layout of the next product, so P never touches shared memory.
//    Row max and sum reduce over the 4 lanes that share a row. K/V tiles
//    are double-buffered in shared memory with cp.async; V's B fragments
//    come through ldmatrix.trans. Zero columns pad D to Dp.
//  * Dp > 256 (the VAE's 512): wide_kernel, WMMA 16×16×16 with the per-warp
//    16×Dp accumulator in shared memory (too wide for registers), 32-row
//    query and key tiles, ≈173 KB of shared memory (dynamic, opt-in).
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

struct AttnTiling {
  int nw, bk, dp, ldq, lds, ldp, ldo;
  size_t off_k, off_v, off_s, off_p, off_o, bytes;
};

__host__ __device__ inline AttnTiling attn_tiling(int D) {
  AttnTiling t;
  t.dp = (D + 15) / 16 * 16;
  t.nw = t.dp > 256 ? 2 : 4;
  t.bk = t.dp > 256 ? 32 : 64;
  t.ldq = t.dp + 8;  // bf16 rows, +8 staggers the banks
  t.lds = t.bk + 4;  // fp32 logits
  t.ldp = t.bk + 8;  // bf16 probabilities
  t.ldo = t.dp + 4;  // fp32 accumulator
  const int bq = 16 * t.nw;
  size_t o = align_up(static_cast<size_t>(bq) * t.ldq * 2, 128);
  t.off_k = o;
  o += align_up(static_cast<size_t>(t.bk) * t.ldq * 2, 128);
  t.off_v = o;
  o += align_up(static_cast<size_t>(t.bk) * t.ldq * 2, 128);
  t.off_s = o;
  o += align_up(static_cast<size_t>(t.nw) * 16 * t.lds * 4, 128);
  t.off_p = o;
  o += align_up(static_cast<size_t>(t.nw) * 16 * t.ldp * 2, 128);
  t.off_o = o;
  o += align_up(static_cast<size_t>(t.nw) * 16 * t.ldo * 4, 128);
  t.bytes = o;
  return t;
}

__global__ void wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, bf16* __restrict__ out,
                                  float* __restrict__ lse, int Sq, int Sk, int H, int D,
                                  float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnTiling t = attn_tiling(D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bq = 16 * t.nw;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * bq;
  const size_t row_stride = static_cast<size_t>(H) * D;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + t.off_k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + t.off_v);
  float* Sw = reinterpret_cast<float*>(smem + t.off_s) + warp * 16 * t.lds;
  bf16* Pw = reinterpret_cast<bf16*>(smem + t.off_p) + warp * 16 * t.ldp;
  float* Ow = reinterpret_cast<float*>(smem + t.off_o) + warp * 16 * t.ldo;

  load_rows(q + (static_cast<size_t>(b) * Sq + q0) * row_stride + static_cast<size_t>(h) * D,
            row_stride, bq, D, t.dp, Qs, t.ldq);
  for (int i = lane; i < 16 * t.ldo; i += 32) Ow[i] = 0.f;

  // lane pair (2r, 2r+1) owns query row r of the warp, one half of its columns
  const int r = lane >> 1, half = lane & 1;
  float m_i = -INFINITY, l_i = 0.f;
  const int kc0 = half * (t.bk / 2), kc1 = kc0 + t.bk / 2;
  const int oc0 = half * (t.dp / 2), oc1 = oc0 + t.dp / 2;

  for (int k0 = 0; k0 < Sk; k0 += t.bk) {
    __syncthreads();  // the previous tile's K/V are no longer read
    const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * row_stride +
                          static_cast<size_t>(h) * D;
    load_rows(k + kv_off, row_stride, t.bk, D, t.dp, Ks, t.ldq);
    load_rows(v + kv_off, row_stride, t.bk, D, t.dp, Vs, t.ldq);
    __syncthreads();

    // S = Q_w · K_tileᵀ (16 × bk, fp32)
    for (int n = 0; n < t.bk / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < t.dp / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (warp * 16) * t.ldq + kk * 16, t.ldq);
        wmma::load_matrix_sync(fb, Ks + (n * 16) * t.ldq + kk * 16, t.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, t.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, in log2 units
    const float* srow = Sw + r * t.lds;
    float mx = -INFINITY;
    for (int c = kc0; c < kc1; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)) * scale_log2;
    const float m_new = fmaxf(m_i, mx);
    const float corr = exp2f(m_i - m_new);
    float sum = 0.f;
    bf16* prow = Pw + r * t.ldp;
    for (int c = kc0; c < kc1; ++c) {
      const bf16 p = __float2bfloat16(exp2f(srow[c] * scale_log2 - m_new));
      prow[c] = p;
      sum += __bfloat162float(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = Ow + r * t.ldo;
    for (int c = oc0; c < oc1; ++c) orow[c] *= corr;
    __syncwarp();

    // O_w += P · V_tile
    for (int n = 0; n < t.dp / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + n * 16, t.ldo, wmma::mem_row_major);
      for (int kk = 0; kk < t.bk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk * 16, t.ldp);
        wmma::load_matrix_sync(fb, Vs + (kk * 16) * t.ldq + n * 16, t.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ow + n * 16, acc, t.ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const float inv_l = 1.f / l_i;
  const float* orow = Ow + r * t.ldo;
  bf16* dst = out + (static_cast<size_t>(b) * Sq + q0 + warp * 16 + r) * row_stride +
              static_cast<size_t>(h) * D;
  for (int c = oc0; c < oc1 && c < D; ++c) dst[c] = __float2bfloat16(orow[c] * inv_l);
  if (lse != nullptr && half == 0)
    lse[static_cast<size_t>(bh) * Sq + q0 + warp * 16 + r] = m_i + log2f(l_i);
}


// ---- register-resident path (Dp <= 256) -------------------------------------

// pack_bf16x2, and add the two rounded values to `sum` (the denominator
// sums exactly the probabilities that enter P·V).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const uint32_t r = pack_bf16x2(lo, hi);
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  sum += __low2float(v) + __high2float(v);
  return r;
}

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
      pa[j / 2][(j % 2) * 2] = pack_bf16(exp2f(s[j][0] * scale_log2 - mn0),
                                         exp2f(s[j][1] * scale_log2 - mn0), ls0);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(exp2f(s[j][2] * scale_log2 - mn1),
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
  const AttnTiling t = attn_tiling(D);
  cudaError_t err = allow_smem(wide_kernel, t.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / (16 * t.nw), B * H);
  wide_kernel<<<grid, 32 * t.nw, t.bytes, st>>>(qp, kp, vp, op, lp, Sq, Sk, H, D, sl2);
  return static_cast<int>(cudaGetLastError());
}
