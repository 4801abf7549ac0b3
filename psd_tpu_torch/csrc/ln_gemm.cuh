// Normalization fused into the A operand of a bf16 GEMM: the WMMA main loop
// of gn_proj_fwd (gn_proj.cu).
//
//   out tile = norm(x)[rows] · W[tile rows]ᵀ,  x (M, C) bf16, W (·, C) bf16
//
// Block: 8 warps over a 128-row × 128-column accumulator tile, K in chunks of
// 32. Prologue (in the including file): the per-row or per-batch parameters
// of the normalization, staged in shared memory. Main loop, double-buffered:
// the W chunk (128 × 32) goes global → shared with cp.async; the x chunk
// (128 × 32) is read into registers one iteration ahead, normalized in fp32
// by the `Norm` functor, rounded to bf16 and stored as the A tile, so the
// normalized x never exists in device memory. Products are WMMA bf16
// 16×16×16 with fp32 accumulation; each warp owns a 32 × 64 strip (8
// fragments). The epilogue (in the including file) reads the strip back
// from a per-warp fp32 stage that reuses the operand buffers.
//
// The norm: GnNorm (a GroupNorm folded into a per-(batch, column) affine; a
// 128-row tile may span two batch elements, so each row carries its batch
// slot). Requires C % 32 == 0; rows at or past M read as 0 and W rows past
// the valid range read as 0.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace psd {
namespace lngemm {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kLd = kBK + 8;           // bf16 operand row stride (80 B)
constexpr int kLdStage = 64 + 4;       // fp32 epilogue stage row stride
constexpr size_t kTileBytes = static_cast<size_t>(kBM) * kLd * 2;  // one A or B buffer
constexpr size_t kOperandBytes = 4 * kTileBytes;                  // A and B, double
constexpr size_t kStageBytes = static_cast<size_t>(kWarps) * 32 * kLdStage * 4;
constexpr size_t kUnionBytes = kOperandBytes > kStageBytes ? kOperandBytes : kStageBytes;

// `n_vec` fp32 vectors of length C follow the per-row array.
inline size_t smem_bytes(int C, int n_vec) {
  return kUnionBytes + kBM * sizeof(float) + static_cast<size_t>(n_vec) * C * sizeof(float);
}

struct Smem {
  bf16* a[2];
  bf16* b[2];
  float* stage;  // aliases the operand buffers after the main loop
  float* row0;   // kBM per-row values (the batch slot, as int)
  float* vec;    // n_vec · C per-column values
};

__device__ inline Smem carve(unsigned char* base) {
  Smem s;
  s.a[0] = reinterpret_cast<bf16*>(base);
  s.a[1] = reinterpret_cast<bf16*>(base + kTileBytes);
  s.b[0] = reinterpret_cast<bf16*>(base + 2 * kTileBytes);
  s.b[1] = reinterpret_cast<bf16*>(base + 3 * kTileBytes);
  s.stage = reinterpret_cast<float*>(base);
  s.row0 = reinterpret_cast<float*>(base + kUnionBytes);
  s.vec = s.row0 + kBM;
  return s;
}

// Folded GroupNorm: x·w[slot_r, c] + b[slot_r, c], two slots of C columns.
struct GnNorm {
  const int* slot;
  const float* w;  // [2][C]
  const float* b;  // [2][C]
  int C;
  __device__ float operator()(int r, int c, float x) const {
    const int o = slot[r] * C + c;
    return x * w[o] + b[o];
  }
};

// The block's raw x chunk: 128 rows × 32 columns = 512 16-byte pieces,
// two per thread. Rows at or past M read as zeros.
struct XRegs {
  uint4 v[2];
};

__device__ inline XRegs load_x(const bf16* __restrict__ x, int row0, int M, int C, int k0) {
  XRegs r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int row = p / 4, c8 = (p % 4) * 8;
    r.v[i] = row0 + row < M
                 ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + row) * C + k0 + c8)
                 : make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <typename Norm>
__device__ inline void store_xhat(const XRegs& r, int k0, const Norm& norm, bf16* a) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int row = p / 4, c8 = (p % 4) * 8;
    const bf16* e = reinterpret_cast<const bf16*>(&r.v[i]);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16(norm(row, k0 + c8 + j, __bfloat162float(e[j])));
    *reinterpret_cast<uint4*>(a + row * kLd + c8) = o;
  }
}

// W chunk: tile row t (0..127) reads W row wrow(t) (or zeros when < 0).
template <typename RowMap>
__device__ inline void load_w_async(const bf16* __restrict__ w, int C, int k0, RowMap wrow,
                                    bf16* b) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int t = p / 4, c8 = (p % 4) * 8;
    bf16* dst = b + t * kLd + c8;
    const int gr = wrow(t);
    if (gr >= 0) {
      __pipeline_memcpy_async(dst, w + static_cast<size_t>(gr) * C + k0 + c8, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  __pipeline_commit();
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Main loop. Warp (wr = warp % 4, wc = warp / 4) accumulates rows
// wr*32 .. +31 against the four tile columns col_of(wc, j), j = 0..3 (each a
// 16-wide fragment). acc[i][j]: row fragment i, column fragment j.
template <typename Norm, typename RowMap, typename ColOf>
__device__ inline void mainloop(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                int row0, int M, int C, const Norm& norm, RowMap wrow,
                                ColOf col_of, const Smem& s, Acc (&acc)[2][4]) {
  const int warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_n = C / kBK;
  load_w_async(w, C, 0, wrow, s.b[0]);
  store_xhat(load_x(x, row0, M, C, 0), 0, norm, s.a[0]);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < kt_n;
    XRegs xr;
    if (more) {
      load_w_async(w, C, (kt + 1) * kBK, wrow, s.b[nxt]);
      xr = load_x(x, row0, M, C, (kt + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], s.a[cur] + (wr * 32 + i * 16) * kLd + kk * 16, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, s.b[cur] + col_of(wc, j) * kLd + kk * 16, kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (more) {
      store_xhat(xr, (kt + 1) * kBK, norm, s.a[nxt]);
      __pipeline_wait_prior(0);
    }
    __syncthreads();
  }
}

// Store a warp's accumulators into its 32 × 64 fp32 stage (after the main
// loop's final __syncthreads the operand buffers are free).
__device__ inline float* stage_acc(const Smem& s, Acc (&acc)[2][4]) {
  const int warp = threadIdx.x / 32;
  float* st = s.stage + warp * 32 * kLdStage;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(st + (i * 16) * kLdStage + j * 16, acc[i][j], kLdStage,
                              wmma::mem_row_major);
  __syncwarp();
  return st;
}

}  // namespace lngemm
}  // namespace psd
