// attention_bwd: the gradient of non-causal softmax attention,
//   O = softmax(Q·Kᵀ·scale)·V,  (B, S, H, D) bf16 operands,
// given dO, O and the forward's per-row log-sum-exp (attention.cu, log2
// units, fp32 (B, H, Sq)). Writes dQ, dK, dV (bf16, the operands' layout).
//
// Replaces the backward of JAX's stock Pallas flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, its dq and dkv kernels),
// which psd_tpu/ops/flash.py:104-121 configures and psd_tpu trains with.
//
// What bounds it on the H100. At the 256² training shape (64, 1024, 8, 40)
// the backward does five S²-sized products (recomputed S, dP, dV, dK, dQ):
// 5·2·B·H·S²·D ≈ 215 GFLOP against ≈ 337 MB of operands and gradients, so
// it is compute-bound on paper; at this small head dim the S² exponentials and
// the elementwise dS work on the CUDA cores cost as much as the products,
// as in the forward.
//
// Three launches, no atomics, deterministic:
//  1. dot_kernel: Δ = rowsum(dO ∘ O) per (batch·head, query), fp32.
//  2. dkv_kernel<Dp>: one block of 4 warps per (64 key rows, batch·head);
//     each warp owns 16 key rows and loops over all query tiles (double-
//     buffered with cp.async: Q, dO, and the tile's log-sum-exp and Δ).
//     Per tile, in registers: Sᵀ = K_w·Qᵀ and dPᵀ = V_w·dOᵀ (mma.sync
//     m16n8k16, bf16 in, fp32 accumulate), Pᵀ = exp2(Sᵀ·scale·log2e − lse),
//     dSᵀ = Pᵀ∘(dPᵀ − Δ); then dV += Pᵀ·dO and dK += dSᵀ·Q, with the
//     accumulator-as-A-operand trick of the forward (P and dS never touch
//     shared memory) and dO/Q fragments through ldmatrix.trans.
//  3. dq_kernel<Dp>: one block per (64 query rows, batch·head), looping over
//     key tiles: S and dP recomputed, dS = P∘(dP − Δ), dQ += dS·K.
// The separate dQ pass recomputes S and dP once more instead of adding dQ
// across key blocks with fp32 atomics: simpler, and the result does not
// depend on the order blocks run in. Head dims pad to Dp = ceil16(D) with
// zero columns, as in the forward. Requires D % 8 == 0, Dp ≤ 160,
// Sq % 64 == 0, Sk % 64 == 0 (the wrapper checks).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace psd {
namespace {

constexpr int kBQ = 64, kBK = 64, kWarps = 4, kThreads = 32 * kWarps;

// 64 rows of one head (row stride H·D) → shared tile of stride DP + 8, by
// cp.async; columns D..DP are zero-filled. The caller commits.
template <int DP>
__device__ __forceinline__ void tile_async(const bf16* __restrict__ src, size_t row_stride,
                                           int D, bf16* dst) {
  constexpr int LD = DP + 8;
  for (int idx = threadIdx.x; idx < 64 * (DP / 8); idx += blockDim.x) {
    const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    if (c < D) {
      __pipeline_memcpy_async(dst + r * LD + c, src + r * row_stride + c, 16);
    } else {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// 64 consecutive floats → shared, by cp.async (16 threads × 16 bytes).
__device__ __forceinline__ void vec64_async(const float* __restrict__ src, float* dst) {
  if (threadIdx.x < 16) __pipeline_memcpy_async(dst + threadIdx.x * 4, src + threadIdx.x * 4, 16);
}

__device__ __forceinline__ void zero(float (&a)[4]) { a[0] = a[1] = a[2] = a[3] = 0.f; }

// A fragment (16 rows × 16 of k) of a warp's rows, from a shared tile; `p`
// points at (row g, column 2·tig) of the warp's first row.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld, int ks) {
  a[0] = ld_u32(p + ks * 16);
  a[1] = ld_u32(p + 8 * ld + ks * 16);
  a[2] = ld_u32(p + ks * 16 + 8);
  a[3] = ld_u32(p + 8 * ld + ks * 16 + 8);
}

// Δ[b, h, q] = Σ_d dO[b, q, h, d]·O[b, q, h, d]; one warp per (b, q, h) row.
__global__ void dot_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                           float* __restrict__ delta, int rows, int Sq, int H, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* a = dout + static_cast<size_t>(row) * D;
  const bf16* o = out + static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c8 = lane; c8 < D / 8; c8 += 32) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c8 * 8);
    const uint4 uo = *reinterpret_cast<const uint4*>(o + c8 * 8);
    const bf16* ea = reinterpret_cast<const bf16*>(&ua);
    const bf16* eo = reinterpret_cast<const bf16*>(&uo);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(ea[i]) * __bfloat162float(eo[i]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    const int h = row % H, q = (row / H) % Sq, b = row / (H * Sq);
    delta[(static_cast<size_t>(b) * H + h) * Sq + q] = s;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int Sq, int Sk, int H, int D, float scale, float scale_log2) {
  constexpr int LD = DP + 8, NO = DP / 8, NS = kBQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * LD;
  bf16* Qs = Vs + kBK * LD;        // [2][BQ][LD]
  bf16* Os = Qs + 2 * kBQ * LD;    // dO, [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(Os + 2 * kBQ * LD);  // [2][BQ]
  float* Ds = Ls + 2 * kBQ;                                  // [2][BQ]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBK;
  const size_t rs = static_cast<size_t>(H) * D, hoff = static_cast<size_t>(h) * D;

  load_rows(k + (static_cast<size_t>(b) * Sk + k0) * rs + hoff, rs, kBK, D, DP, Ks, LD);
  load_rows(v + (static_cast<size_t>(b) * Sk + k0) * rs + hoff, rs, kBK, D, DP, Vs, LD);

  auto load_q = [&](int tile, int buf) {
    const size_t base = (static_cast<size_t>(b) * Sq + tile * kBQ) * rs + hoff;
    tile_async<DP>(q + base, rs, D, Qs + buf * kBQ * LD);
    tile_async<DP>(dout + base, rs, D, Os + buf * kBQ * LD);
    const size_t vb = static_cast<size_t>(bh) * Sq + tile * kBQ;
    vec64_async(lse + vb, Ls + buf * kBQ);
    vec64_async(delta + vb, Ds + buf * kBQ);
    __pipeline_commit();
  };

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    zero(dka[n]);
    zero(dva[n]);
  }
  const bf16* kw = Ks + (warp * 16 + g) * LD + tig * 2;
  const bf16* vw = Vs + (warp * 16 + g) * LD + tig * 2;

  const int n_tiles = Sq / kBQ;
  load_q(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      load_q(t + 1, cur ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* qc = Qs + cur * kBQ * LD;
    const bf16* oc = Os + cur * kBQ * LD;
    const float* lc = Ls + cur * kBQ;
    const float* dc = Ds + cur * kBQ;

    // Sᵀ = K_w·Qᵀ and dPᵀ = V_w·dOᵀ: 16 key rows × 64 queries per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      zero(s[j]);
      zero(dp[j]);
    }
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t ak[4], av[4];
      load_a(ak, kw, LD, ks);
      load_a(av, vw, LD, ks);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* qp = qc + (j * 8 + g) * LD + ks * 16 + tig * 2;
        const bf16* op = oc + (j * 8 + g) * LD + ks * 16 + tig * 2;
        mma_bf16(s[j], ak, ld_u32(qp), ld_u32(qp + 8));
        mma_bf16(dp[j], av, ld_u32(op), ld_u32(op + 8));
      }
    }

    // Pᵀ and dSᵀ; this lane's columns are queries j·8 + 2·tig (+1)
    uint32_t pa[NS / 2][4], da[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * 8 + tig * 2;
      const float l0 = lc[c], l1 = lc[c + 1], d0 = dc[c], d1 = dc[c + 1];
      const float p0 = exp2f(s[j][0] * scale_log2 - l0);
      const float p1 = exp2f(s[j][1] * scale_log2 - l1);
      const float p2 = exp2f(s[j][2] * scale_log2 - l0);
      const float p3 = exp2f(s[j][3] * scale_log2 - l1);
      pa[j / 2][(j % 2) * 2] = pack_bf16x2(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2, p3);
      da[j / 2][(j % 2) * 2] = pack_bf16x2(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d1));
      da[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2 * (dp[j][2] - d0), p3 * (dp[j][3] - d1));
    }

    // dV += Pᵀ·dO, dK += dSᵀ·Q
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const bf16* orow = oc + (kk * 16 + (lane & 15)) * LD;
      const bf16* qrow = qc + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, orow + n * 8);
        mma_bf16(dva[n], pa[kk], b0, b1);
        ldmatrix_x2_trans(b0, b1, qrow + n * 8);
        mma_bf16(dka[n], da[kk], b0, b1);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  const size_t r0 = (static_cast<size_t>(b) * Sk + k0 + warp * 16 + g) * rs + hoff;
  const size_t r1 = r0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (n * 8 < D) {
      *reinterpret_cast<__nv_bfloat162*>(dk + r0 + c) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dk + r1 + c) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + r0 + c) = __floats2bfloat162_rn(dva[n][0], dva[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + r1 + c) = __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H, int D,
          float scale, float scale_log2) {
  constexpr int LD = DP + 8, NO = DP / 8, NS = kBK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kBQ * LD;          // dO
  bf16* Ks = Os + kBQ * LD;          // [2][BK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;      // [2][BK][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t rs = static_cast<size_t>(H) * D, hoff = static_cast<size_t>(h) * D;

  load_rows(q + (static_cast<size_t>(b) * Sq + q0) * rs + hoff, rs, kBQ, D, DP, Qs, LD);
  load_rows(dout + (static_cast<size_t>(b) * Sq + q0) * rs + hoff, rs, kBQ, D, DP, Os, LD);
  const size_t rb = static_cast<size_t>(bh) * Sq + q0 + warp * 16 + g;
  const float l0 = lse[rb], l1 = lse[rb + 8], d0 = delta[rb], d1 = delta[rb + 8];

  auto load_kv = [&](int tile, int buf) {
    const size_t base = (static_cast<size_t>(b) * Sk + tile * kBK) * rs + hoff;
    tile_async<DP>(k + base, rs, D, Ks + buf * kBK * LD);
    tile_async<DP>(v + base, rs, D, Vs + buf * kBK * LD);
    __pipeline_commit();
  };

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) zero(dqa[n]);
  const bf16* qw = Qs + (warp * 16 + g) * LD + tig * 2;
  const bf16* ow = Os + (warp * 16 + g) * LD + tig * 2;

  const int n_tiles = Sk / kBK;
  load_kv(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, cur ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* kc = Ks + cur * kBK * LD;
    const bf16* vc = Vs + cur * kBK * LD;

    // S = Q_w·Kᵀ and dP = dO_w·Vᵀ: 16 query rows × 64 keys per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      zero(s[j]);
      zero(dp[j]);
    }
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t aq[4], ao[4];
      load_a(aq, qw, LD, ks);
      load_a(ao, ow, LD, ks);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kp = kc + (j * 8 + g) * LD + ks * 16 + tig * 2;
        const bf16* vp = vc + (j * 8 + g) * LD + ks * 16 + tig * 2;
        mma_bf16(s[j], aq, ld_u32(kp), ld_u32(kp + 8));
        mma_bf16(dp[j], ao, ld_u32(vp), ld_u32(vp + 8));
      }
    }

    // dS = P∘(dP − Δ); rows g (c0, c1) and g + 8 (c2, c3)
    uint32_t da[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[j][0] * scale_log2 - l0);
      const float p1 = exp2f(s[j][1] * scale_log2 - l0);
      const float p2 = exp2f(s[j][2] * scale_log2 - l1);
      const float p3 = exp2f(s[j][3] * scale_log2 - l1);
      da[j / 2][(j % 2) * 2] = pack_bf16x2(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d0));
      da[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2 * (dp[j][2] - d1), p3 * (dp[j][3] - d1));
    }

    // dQ += dS·K
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const bf16* krow = kc + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, krow + n * 8);
        mma_bf16(dqa[n], da[kk], b0, b1);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  bf16* r0 = dq + (static_cast<size_t>(b) * Sq + q0 + warp * 16 + g) * rs + hoff;
  bf16* r1 = r0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (n * 8 < D) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + c) =
          __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(r1 + c) =
          __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
    }
  }
}

template <int DP>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                       const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                       bf16* dv, int B, int Sq, int Sk, int H, int D, float scale,
                       cudaStream_t st) {
  constexpr int LD = DP + 8;
  const float sl2 = scale * kLog2e;
  const int rows = B * Sq * H;
  dot_kernel<<<(rows + 7) / 8, 256, 0, st>>>(dout, out, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t kv_bytes = static_cast<size_t>(2 * kBK + 4 * kBQ) * LD * 2 + 4 * kBQ * sizeof(float);
  err = allow_smem(dkv_kernel<DP>, kv_bytes);
  if (err != cudaSuccess) return err;
  dkv_kernel<DP><<<dim3(Sk / kBK, B * H), kThreads, kv_bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, D, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t q_bytes = static_cast<size_t>(2 * kBQ + 4 * kBK) * LD * 2;
  err = allow_smem(dq_kernel<DP>, q_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<dim3(Sq / kBQ, B * H), kThreads, q_bytes, st>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, D, scale, sl2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace psd

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
#define PSD_BWD(DP) \
  launch_bwd<DP>(qp, kp, vp, op, gp, lp, dl, dqp, dkp, dvp, B, Sq, Sk, H, D, scale, st)
  switch ((D + 15) / 16 * 16) {
    case 32: return static_cast<int>(PSD_BWD(32));
    case 48: return static_cast<int>(PSD_BWD(48));
    case 64: return static_cast<int>(PSD_BWD(64));
    case 80: return static_cast<int>(PSD_BWD(80));
    case 96: return static_cast<int>(PSD_BWD(96));
    case 128: return static_cast<int>(PSD_BWD(128));
    case 160: return static_cast<int>(PSD_BWD(160));
    default: break;
  }
#undef PSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
