// attention_q8_fwd: int8 spatial attention, the counterpart of
// psd_tpu/ops/spattn.py::_kernel_q8 (reached through
// spatial_attention(quant="qk8" | "int8")).
//
// Inputs arrive quantized by the plain-torch pre-pass (ops/attention.py
// quantize_qkv): qq, kq int8 (B·H, S, Dp) with D zero-padded to Dp =
// ceil32(D); sq, sk fp32 (B·H, S) row scales; and
//  * "qk8": v bf16 (B, S, H, D) as the model holds it;
//  * "int8": vq int8 (B·H, Dp, S), key-major, with sv fp32 (B·H, Dp)
//    column scales over S.
// Output bf16 (B, S, H, D). Per query row (log2 units, c = scale·log2e):
//   x = acc·(sq·c)·sk,  m = max x,  p = exp2(x − m),  l = Σp (fp32)
//   "qk8":  out = (Σ bf16(p)·v) / l
//   "int8": pn = p/l, ps = max(max pn, 1e-20)/127 (max pn = 1/l: the row
//           max contributes exp2(0) = 1), pq = rint(pn/ps) (half to even),
//           out = (Σ pq·vq)·ps·sv.
//
// What bounds it on the H100. At (8, 4096, 8, 40) the function is 86 G
// int8 ops (QKᵀ) + 86 G bf16 or int8 ops (P·V) against 11 MB of
// operands: operations-bound, and, as in the bf16 kernel, the S² softmax
// elementwise work (exp2, the dequant multiplies, and in "int8" two fp32
// divisions and a rounding per logit) on the CUDA cores costs more than the
// tensor-core products at this small D.
//
// Design. The TPU kernel keeps a whole logit row resident and takes the
// exact softmax once. A 64-row tile at S = 4096 would be 1 MB of fp32 here,
// and "int8" quantizes p with a scale that needs the final m and l before
// any P·V product, so a single online pass cannot reproduce its rounding.
// So two passes over the keys, for both modes: pass 1 computes QKᵀ and
// keeps the running row max m and sum l (online); pass 2 recomputes QKᵀ,
// forms p against the final m, and runs P·V. "qk8" could fold into one
// online pass (it is linear in p once m is known); two passes keep one code
// path and give bf16(p) exactly as psd_tpu rounds it. One block of 4 warps
// per (64 query rows, b·h), each warp 16 rows; K (and V in pass 2) tiles of
// 64 keys double-buffered in shared memory with cp.async, one tile sequence
// over both passes.
//  * QKᵀ: mma.sync m16n8k32 s8·s8 → s32. Its accumulator has the per-thread
//    layout of m16n8k16's f32 accumulator, so "qk8" reuses the bf16 kernel's
//    register path: P becomes the A operand of an m16n8k16 bf16 product, V's
//    B fragments come through ldmatrix.trans.
//  * "int8" P·V: the s8 A operand holds 4 consecutive k per register, the
//    accumulator pairs of columns. The keys are permuted within each
//    32-key chunk instead of moving data between threads: logical k = 4·tig
//    + e reads key 2·tig + {0, 1, 8, 9}[e] (and +16 for the upper half),
//    which is exactly what thread tig holds in the accumulator; V's B
//    fragment reads the same keys, two 16-bit loads from the key-major
//    tile (ldmatrix .trans moves only 16-bit elements). The contraction
//    over keys does not depend on their order.
// Requires D % 8 == 0, Dp ≤ 256, S % 64 == 0 (the wrapper checks).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace psd {
namespace {

constexpr int kQ8BQ = 64, kQ8BK = 64, kQ8Warps = 4;
constexpr float kInv127 = 1.0f / 127.0f;

// mma.sync m16n8k32, s8 operands, s32 accumulate, in place: d += a·b.
// A: register r holds 4 consecutive k of row g (r = 0, 2) or g + 8 (r = 1,
// 3) at k = 4·tig (r = 0, 1) or 16 + 4·tig (r = 2, 3); B: b0 holds k =
// 4·tig..+3, b1 k = 16 + 4·tig..+3, at column g; C/D as m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_b32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_b16(const int8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// shared memory: Q tile, then two buffers of (K tile, sk tile, V tile)
template <int DP, bool PV8>
struct Q8Tiling {
  static constexpr int LDQ = DP + 16;                     // int8 rows, +16 staggers the banks
  static constexpr int LDV = PV8 ? kQ8BK + 16 : DP + 8;   // int8 Vᵀ rows (bytes) / bf16 V rows
  static constexpr size_t Q = static_cast<size_t>(kQ8BQ) * LDQ;
  static constexpr size_t K = static_cast<size_t>(kQ8BK) * LDQ;
  static constexpr size_t SK = kQ8BK * 4;
  static constexpr size_t V = PV8 ? static_cast<size_t>(DP) * LDV
                                  : static_cast<size_t>(kQ8BK) * LDV * 2;
  static constexpr size_t BUF = K + SK + V;
  static constexpr size_t BYTES = Q + 2 * BUF;
};

template <int DP, bool PV8>
__global__ void __launch_bounds__(32 * kQ8Warps)
q8_kernel(const int8_t* __restrict__ qq, const float* __restrict__ sq,
          const int8_t* __restrict__ kq, const float* __restrict__ sk,
          const void* __restrict__ vp, const float* __restrict__ sv, bf16* __restrict__ out,
          int S, int H, int D, float c) {
  using T = Q8Tiling<DP, PV8>;
  constexpr int LDQ = T::LDQ, LDV = T::LDV, NS = kQ8BK / 8, NO = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  unsigned char* bufs = smem + T::Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kQ8BQ;
  const int n_tiles = S / kQ8BK;

  {
    const int8_t* src = qq + (static_cast<size_t>(bh) * S + q0) * DP;
    for (int idx = threadIdx.x; idx < kQ8BQ * (DP / 16); idx += blockDim.x) {
      const int r = idx / (DP / 16), cc = (idx % (DP / 16)) * 16;
      *reinterpret_cast<uint4*>(Qs + r * LDQ + cc) =
          *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * DP + cc);
    }
  }

  // tile t < n_tiles: pass 1 (K, sk); t ≥ n_tiles: pass 2 (K, sk, V)
  auto load = [&](int t, int buf) {
    const bool pass2 = t >= n_tiles;
    const int k0 = (pass2 ? t - n_tiles : t) * kQ8BK;
    unsigned char* base = bufs + buf * T::BUF;
    int8_t* kd = reinterpret_cast<int8_t*>(base);
    const int8_t* ks = kq + (static_cast<size_t>(bh) * S + k0) * DP;
    for (int idx = threadIdx.x; idx < kQ8BK * (DP / 16); idx += blockDim.x) {
      const int r = idx / (DP / 16), cc = (idx % (DP / 16)) * 16;
      __pipeline_memcpy_async(kd + r * LDQ + cc, ks + static_cast<size_t>(r) * DP + cc, 16);
    }
    if (threadIdx.x < kQ8BK / 4)
      __pipeline_memcpy_async(reinterpret_cast<float*>(base + T::K) + threadIdx.x * 4,
                              sk + static_cast<size_t>(bh) * S + k0 + threadIdx.x * 4, 16);
    if (pass2) {
      if constexpr (PV8) {
        int8_t* vd = reinterpret_cast<int8_t*>(base + T::K + T::SK);
        const int8_t* vs = static_cast<const int8_t*>(vp) + static_cast<size_t>(bh) * DP * S + k0;
        for (int idx = threadIdx.x; idx < DP * (kQ8BK / 16); idx += blockDim.x) {
          const int r = idx / (kQ8BK / 16), cc = (idx % (kQ8BK / 16)) * 16;
          __pipeline_memcpy_async(vd + r * LDV + cc, vs + static_cast<size_t>(r) * S + cc, 16);
        }
      } else {
        bf16* vd = reinterpret_cast<bf16*>(base + T::K + T::SK);
        const size_t row_stride = static_cast<size_t>(H) * D;
        const bf16* vs = static_cast<const bf16*>(vp) +
                         (static_cast<size_t>(b) * S + k0) * row_stride + static_cast<size_t>(h) * D;
        for (int idx = threadIdx.x; idx < kQ8BK * (DP / 8); idx += blockDim.x) {
          const int r = idx / (DP / 8), cc = (idx % (DP / 8)) * 8;
          if (cc < D)
            __pipeline_memcpy_async(vd + r * LDV + cc, vs + r * row_stride + cc, 16);
          else
            *reinterpret_cast<uint4*>(vd + r * LDV + cc) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    __pipeline_commit();
  };

  const size_t row0 = static_cast<size_t>(bh) * S + q0 + warp * 16 + g;
  const float rq0 = sq[row0] * c, rq1 = sq[row0 + 8] * c;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, ps0 = 0.f, ps1 = 0.f;
  float of[PV8 ? 1 : NO][4];
  int oi[PV8 ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < (PV8 ? 1 : NO); ++n) of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < (PV8 ? NO : 1); ++n) oi[n][0] = oi[n][1] = oi[n][2] = oi[n][3] = 0;
  const int8_t* qw = Qs + (warp * 16 + g) * LDQ + tig * 4;

  load(0, 0);
  for (int t = 0; t < 2 * n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < 2 * n_tiles) {
      load(t + 1, cur ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const unsigned char* base = bufs + cur * T::BUF;
    const int8_t* kc = reinterpret_cast<const int8_t*>(base);
    const float* skc = reinterpret_cast<const float*>(base + T::K);

    // QKᵀ, 16 × 64 per warp, int32 in registers
    int si[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
    for (int ks = 0; ks < DP / 32; ++ks) {
      const uint32_t a[4] = {ld_b32(qw + ks * 32), ld_b32(qw + 8 * LDQ + ks * 32),
                             ld_b32(qw + ks * 32 + 16), ld_b32(qw + 8 * LDQ + ks * 32 + 16)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int8_t* kp = kc + (j * 8 + g) * LDQ + ks * 32 + tig * 4;
        mma_s8(si[j], a, ld_b32(kp), ld_b32(kp + 16));
      }
    }
    // exact per-element dequant, in log2 units: (acc·(sq·c))·sk; rows g
    // (elements 0, 1) and g + 8 (2, 3), keys j·8 + 2·tig (+1)
    float x[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float s0 = skc[j * 8 + 2 * tig], s1 = skc[j * 8 + 2 * tig + 1];
      x[j][0] = static_cast<float>(si[j][0]) * rq0 * s0;
      x[j][1] = static_cast<float>(si[j][1]) * rq0 * s1;
      x[j][2] = static_cast<float>(si[j][2]) * rq1 * s0;
      x[j][3] = static_cast<float>(si[j][3]) * rq1 * s1;
    }

    if (t < n_tiles) {
      // pass 1: running max and sum (each lane sums its own columns)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx0 = fmaxf(mx0, fmaxf(x[j][0], x[j][1]));
        mx1 = fmaxf(mx1, fmaxf(x[j][2], x[j][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        ls0 += exp2f(x[j][0] - mn0) + exp2f(x[j][1] - mn0);
        ls1 += exp2f(x[j][2] - mn1) + exp2f(x[j][3] - mn1);
      }
      l0 = l0 * exp2f(m0 - mn0) + ls0;
      l1 = l1 * exp2f(m1 - mn1) + ls1;
      m0 = mn0;
      m1 = mn1;
    } else {
      if (t == n_tiles) {  // the final m and l; the row's sum over its 4 lanes
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
          l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
        }
        ps0 = fmaxf(1.f / l0, 1e-20f) * kInv127;
        ps1 = fmaxf(1.f / l1, 1e-20f) * kInv127;
      }
      // pass 2: p against the final max, then P·V
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        x[j][0] = exp2f(x[j][0] - m0);
        x[j][1] = exp2f(x[j][1] - m0);
        x[j][2] = exp2f(x[j][2] - m1);
        x[j][3] = exp2f(x[j][3] - m1);
      }
      if constexpr (PV8) {
        const int8_t* vc = reinterpret_cast<const int8_t*>(base + T::K + T::SK);
        int pq[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          pq[j][0] = __float2int_rn((x[j][0] / l0) / ps0);
          pq[j][1] = __float2int_rn((x[j][1] / l0) / ps0);
          pq[j][2] = __float2int_rn((x[j][2] / l1) / ps1);
          pq[j][3] = __float2int_rn((x[j][3] / l1) / ps1);
        }
#pragma unroll
        for (int ch = 0; ch < kQ8BK / 32; ++ch) {
          const int j0 = ch * 4;
          // logical k = 4·tig + e ↔ key 2·tig + {0, 1, 8, 9}[e] (+16 in a[2], a[3])
          const uint32_t a[4] = {
              pack_s8(pq[j0][0], pq[j0][1], pq[j0 + 1][0], pq[j0 + 1][1]),
              pack_s8(pq[j0][2], pq[j0][3], pq[j0 + 1][2], pq[j0 + 1][3]),
              pack_s8(pq[j0 + 2][0], pq[j0 + 2][1], pq[j0 + 3][0], pq[j0 + 3][1]),
              pack_s8(pq[j0 + 2][2], pq[j0 + 2][3], pq[j0 + 3][2], pq[j0 + 3][3])};
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const int8_t* vr = vc + (n * 8 + g) * LDV + ch * 32 + 2 * tig;
            mma_s8(oi[n], a, ld_b16(vr) | (ld_b16(vr + 8) << 16),
                   ld_b16(vr + 16) | (ld_b16(vr + 24) << 16));
          }
        }
      } else {
        const bf16* vc = reinterpret_cast<const bf16*>(base + T::K + T::SK);
        uint32_t pa[NS / 2][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          pa[j / 2][(j % 2) * 2] = pack_bf16x2(x[j][0], x[j][1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(x[j][2], x[j][3]);
        }
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const bf16* vrow = vc + (kk * 16 + (lane & 15)) * LDV;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, vrow + n * 8);
            mma_bf16(of[n], pa[kk], b0, b1);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  bf16* r0 = out + (static_cast<size_t>(b) * S + q0 + warp * 16 + g) * row_stride +
             static_cast<size_t>(h) * D;
  bf16* r1 = r0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + tig * 2;
    if (n * 8 < D) {
      float v00, v01, v10, v11;
      if constexpr (PV8) {
        const float s0 = sv[static_cast<size_t>(bh) * DP + col];
        const float s1 = sv[static_cast<size_t>(bh) * DP + col + 1];
        v00 = static_cast<float>(oi[n][0]) * ps0 * s0;
        v01 = static_cast<float>(oi[n][1]) * ps0 * s1;
        v10 = static_cast<float>(oi[n][2]) * ps1 * s0;
        v11 = static_cast<float>(oi[n][3]) * ps1 * s1;
      } else {
        v00 = of[n][0] / l0;
        v01 = of[n][1] / l0;
        v10 = of[n][2] / l1;
        v11 = of[n][3] / l1;
      }
      *reinterpret_cast<__nv_bfloat162*>(r0 + col) = __floats2bfloat162_rn(v00, v01);
      *reinterpret_cast<__nv_bfloat162*>(r1 + col) = __floats2bfloat162_rn(v10, v11);
    }
  }
}

template <int DP, bool PV8>
cudaError_t launch_q8(const int8_t* qq, const float* sq, const int8_t* kq, const float* sk,
                      const void* v, const float* sv, bf16* out, int B, int S, int H, int D,
                      float c, cudaStream_t st) {
  const size_t bytes = Q8Tiling<DP, PV8>::BYTES;
  cudaError_t err = allow_smem(q8_kernel<DP, PV8>, bytes);
  if (err != cudaSuccess) return err;
  q8_kernel<DP, PV8><<<dim3(S / kQ8BQ, B * H), 32 * kQ8Warps, bytes, st>>>(
      qq, sq, kq, sk, v, sv, out, S, H, D, c);
  return cudaGetLastError();
}

template <bool PV8>
cudaError_t dispatch_q8(int DP, const int8_t* qq, const float* sq, const int8_t* kq,
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
  const int dp = (D + 31) / 32 * 32;
  const int8_t* qp = static_cast<const int8_t*>(qq);
  const int8_t* kp = static_cast<const int8_t*>(kq);
  const float* sqp = static_cast<const float*>(sq);
  const float* skp = static_cast<const float*>(sk);
  const float* svp = static_cast<const float*>(sv);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pv8 ? dispatch_q8<true>(dp, qp, sqp, kp, skp, v, svp, op, B, S, H, D, scale_log2, st)
          : dispatch_q8<false>(dp, qp, sqp, kp, skp, v, svp, op, B, S, H, D, scale_log2, st);
  return static_cast<int>(err);
}
