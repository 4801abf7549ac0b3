// Descriptor probes for the wgmma shapes of the narrow attention forward and
// the attention backward, one warpgroup each: S = q·kᵀ by wgmma_ss<BK> (q and K both K-major, from TMA tiles of
// 3-D (D, H, rows) maps with 64-column boxes and the 128-byte swizzle) and
// O = P·V by wgmma_rs_tb<Dp> (P from registers, V MN-major from a TMA tile),
// each written out in full for scripts/torch_wgmma_probe.py to hold against
// fp32 torch.matmul. And the LayerNorm GEMMs' product (ln_gemm_sm90.cuh):
// D = X·Wᵀ by wgmma_rs<N>, the A fragments ldmatrix-ed from a swizzled
// TMA tile of X (64 rows × 64 columns at K chunk kc), B K-major from N W
// rows stacked as N/R boxes of R rows, rows past W's reading as zeros.
// And the s8 products of attention_q8.cu: S = q·kᵀ by wgmma_ss_s8<64> on
// one warpgroup's 64 rows of a 128-row q tile against one 64-key half of a
// 128-key K tile, both from 2-D int8 maps whose 128-byte boxes TMA fills
// with zeros past Dp; and O = P·Vᵀ by wgmma_rs_s8<Dp>, V a (Dp × 128) int8
// tile, A either loaded as the s8 fragment of a row-major P or built, as
// the kernel builds it, from P in the s32 accumulator layout with V's keys
// placed within each 32-key chunk (ops/attention.py q8_place_keys).
// Built on its own with nvcc (not part of the kernels' library).
#include "common.cuh"
#include "hopper.cuh"
using namespace psd;
using namespace psd::hopper;

template <int DP, int BK>
__global__ void probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const bf16* P, float* S, float* O, int h) {
  constexpr int NB = (DP + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t qbytes = 64 * NB * 128, tbytes = BK * NB * 128;
  unsigned char* qs = smem;
  unsigned char* ks = smem + qbytes;
  unsigned char* vs = ks + tbytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + tbytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, qbytes + 2 * tbytes);
    for (int c = 0; c < NB; ++c) {
      tma_load_3d(qs + c * 64 * 128, &tq, bar, c * 64, h, 0);
      tma_load_3d(ks + c * BK * 128, &tk, bar, c * 64, h, 0);
      tma_load_3d(vs + c * BK * 128, &tv, bar, c * 64, h, 0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + g;
  float sc[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t box = kk >> 2, in_box = (kk & 3) * 32;
    wgmma_ss<BK>(sc, wgmma_desc(smem_addr(qs) + box * 64 * 128 + in_box, 16, 1024),
                 wgmma_desc(smem_addr(ks) + box * BK * 128 + in_box, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);
  for (int j = 0; j < BK / 8; ++j) {
    S[r0 * BK + 8 * j + 2 * tig] = sc[4 * j];
    S[r0 * BK + 8 * j + 2 * tig + 1] = sc[4 * j + 1];
    S[(r0 + 8) * BK + 8 * j + 2 * tig] = sc[4 * j + 2];
    S[(r0 + 8) * BK + 8 * j + 2 * tig + 1] = sc[4 * j + 3];
  }
  uint32_t pa[BK / 16][4];
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int c0 = 16 * kk + 2 * tig;
    pa[kk][0] = *reinterpret_cast<const uint32_t*>(P + r0 * BK + c0);
    pa[kk][1] = *reinterpret_cast<const uint32_t*>(P + (r0 + 8) * BK + c0);
    pa[kk][2] = *reinterpret_cast<const uint32_t*>(P + r0 * BK + c0 + 8);
    pa[kk][3] = *reinterpret_cast<const uint32_t*>(P + (r0 + 8) * BK + c0 + 8);
  }
  float o[DP / 2];
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_tb<DP>(o, pa[kk], wgmma_desc(smem_addr(vs) + kk * 16 * 128, BK * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
  for (int n = 0; n < DP / 8; ++n) {
    O[r0 * DP + 8 * n + 2 * tig] = o[4 * n];
    O[r0 * DP + 8 * n + 2 * tig + 1] = o[4 * n + 1];
    O[(r0 + 8) * DP + 8 * n + 2 * tig] = o[4 * n + 2];
    O[(r0 + 8) * DP + 8 * n + 2 * tig + 1] = o[4 * n + 3];
  }
}

template <int DP, int BK>
int run(const void* q, const void* k, const void* v, const void* P, void* S, void* O, int H, int D, int h) {
  CUtensorMap tq, tk, tv;
  if (!bf16_rows_map(&tq, q, 64, H, D, 64) || !bf16_rows_map(&tk, k, BK, H, D, BK) ||
      !bf16_rows_map(&tv, v, BK, H, D, BK))
    return -1;
  constexpr int NB = (DP + 63) / 64;
  const size_t smem = (64 + 2 * BK) * NB * 128 + 8 + 1024;
  cudaError_t e = allow_smem(probe_kernel<DP, BK>, smem);
  if (e != cudaSuccess) return e;
  probe_kernel<DP, BK><<<1, 128, smem>>>(tq, tk, tv, (const bf16*)P, (float*)S, (float*)O, h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}

extern "C" int probe_run(int DP, int BK, const void* q, const void* k, const void* v, const void* P,
                         void* S, void* O, int H, int D, int h) {
  if (DP == 32 && BK == 64) return run<32, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 48 && BK == 64) return run<48, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 64 && BK == 64) return run<64, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 32 && BK == 128) return run<32, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 48 && BK == 128) return run<48, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 64 && BK == 128) return run<64, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 80 && BK == 128) return run<80, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 96 && BK == 128) return run<96, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 128 && BK == 128) return run<128, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 160 && BK == 64) return run<160, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 80 && BK == 64) return run<80, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 96 && BK == 64) return run<96, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 128 && BK == 64) return run<128, 64>(q, k, v, P, S, O, H, D, h);
  if (DP == 128 && BK == 32) return run<128, 32>(q, k, v, P, S, O, H, D, h);
  if (DP == 160 && BK == 32) return run<160, 32>(q, k, v, P, S, O, H, D, h);
  if (DP == 192 && BK == 128) return run<192, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 224 && BK == 128) return run<224, 128>(q, k, v, P, S, O, H, D, h);
  if (DP == 256 && BK == 128) return run<256, 128>(q, k, v, P, S, O, H, D, h);
  return -2;
}


template <int N, int R>
__global__ void probe_rs_kernel(const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tw, float* D, int kc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xs = smem;
  unsigned char* ws = smem + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + N * 128);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 + N) * 128);
    tma_load_3d(xs, &tx, bar, kc * 64, 0, 0);
    for (int i = 0; i < N / R; ++i) tma_load_3d(ws + i * R * 128, &tw, bar, kc * 64, 0, i * R);
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const uint32_t lrow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4][4];
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], smem_addr(xs) + lrow * 128 + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N>(d, a[kk], wgmma_desc(smem_addr(ws) + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < N / 2; ++i) reg_fence(d[i]);
  const int r0 = 16 * warp + g;
  for (int j = 0; j < N / 8; ++j) {
    D[r0 * N + 8 * j + 2 * tig] = d[4 * j];
    D[r0 * N + 8 * j + 2 * tig + 1] = d[4 * j + 1];
    D[(r0 + 8) * N + 8 * j + 2 * tig] = d[4 * j + 2];
    D[(r0 + 8) * N + 8 * j + 2 * tig + 1] = d[4 * j + 3];
  }
}

template <int N, int R>
int run_rs(const void* x, const void* w, void* D, int C, int Nw, int kc) {
  CUtensorMap tx, tw;
  if (!bf16_rows_map(&tx, x, 64, 1, C, 64) || !bf16_rows_map(&tw, w, Nw, 1, C, R)) return -1;
  const size_t smem = (64 + N) * 128 + 8 + 1024;
  cudaError_t e = allow_smem(probe_rs_kernel<N, R>, smem);
  if (e != cudaSuccess) return e;
  probe_rs_kernel<N, R><<<1, 128, smem>>>(tx, tw, (float*)D, kc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}

// x (64, C) and w (Nw, C) bf16; D (64, N) fp32 = x[:, 64kc:64kc+64] ·
// w[:, 64kc:64kc+64]ᵀ with W rows past Nw as zeros.
extern "C" int probe_rs_run(int N, int R, const void* x, const void* w, void* D, int C, int Nw,
                            int kc) {
  if (N == 160 && R == 160) return run_rs<160, 160>(x, w, D, C, Nw, kc);
  if (N == 192 && R == 64) return run_rs<192, 64>(x, w, D, C, Nw, kc);
  if (N == 256 && R == 128) return run_rs<256, 128>(x, w, D, C, Nw, kc);
  return -2;
}


template <int DP>
__global__ void probe_s8_ss_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk, int* S, int c, int hh) {
  constexpr int RB = 128, NB = (DP + RB - 1) / RB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + NB * 128 * RB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ks + NB * 128 * RB);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 2 * NB * 128 * RB);
    for (int x = 0; x < NB; ++x) {
      tma_load_2d(qs + x * 128 * RB, &tq, bar, x * RB, 0);
      tma_load_2d(ks + x * 128 * RB, &tk, bar, x * RB, 0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  int acc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk) {
    const uint32_t box = kk >> 2, in_box = (kk & 3) * 32;
    wgmma_ss_s8<64>(acc, wgmma_desc(smem_addr(qs) + c * 64 * RB + box * 128 * RB + in_box, 16, 1024),
                    wgmma_desc(smem_addr(ks) + hh * 64 * RB + box * 128 * RB + in_box, 16, 1024),
                    kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
  const int r0 = 16 * warp + g;
  for (int j = 0; j < 8; ++j) {
    S[r0 * 64 + 8 * j + 2 * tig] = acc[4 * j];
    S[r0 * 64 + 8 * j + 2 * tig + 1] = acc[4 * j + 1];
    S[(r0 + 8) * 64 + 8 * j + 2 * tig] = acc[4 * j + 2];
    S[(r0 + 8) * 64 + 8 * j + 2 * tig + 1] = acc[4 * j + 3];
  }
}

template <int DP>
int run_s8_ss(const void* q, const void* k, void* S, int c, int hh) {
  constexpr int RB = 128, NB = (DP + RB - 1) / RB;
  CUtensorMap tq, tk;
  if (!s8_rows_map(&tq, q, 128, DP, 128) || !s8_rows_map(&tk, k, 128, DP, 128)) return -1;
  const size_t smem = 2 * NB * 128 * RB + 8 + 1024;
  cudaError_t e = allow_smem(probe_s8_ss_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  probe_s8_ss_kernel<DP><<<1, 128, smem>>>(tq, tk, (int*)S, c, hh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}

// q (128, DP) and k (128, DP) int8; S (64, 64) int32 = q[64c:64c+64] ·
// k[64hh:64hh+64]ᵀ
extern "C" int probe_s8_ss_run(int DP, const void* q, const void* k, void* S, int c, int hh) {
  switch (DP) {
    case 32: return run_s8_ss<32>(q, k, S, c, hh);
    case 64: return run_s8_ss<64>(q, k, S, c, hh);
    case 96: return run_s8_ss<96>(q, k, S, c, hh);
    case 128: return run_s8_ss<128>(q, k, S, c, hh);
    case 160: return run_s8_ss<160>(q, k, S, c, hh);
    case 192: return run_s8_ss<192>(q, k, S, c, hh);
    case 224: return run_s8_ss<224>(q, k, S, c, hh);
    case 256: return run_s8_ss<256>(q, k, S, c, hh);
    default: return -2;
  }
}

__device__ __forceinline__ uint32_t low_bytes4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <int DP>
__global__ void probe_s8_rs_kernel(const __grid_constant__ CUtensorMap tv, const int8_t* P, int* O,
                                   int placed) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + DP * 128);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, DP * 128);
    tma_load_2d(smem, &tv, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + g;
  uint32_t a[4][4];
  for (int ks = 0; ks < 4; ++ks) {
    if (placed) {
      // P in the s32 accumulator layout (row r0 and r0 + 8, keys 8j + 2·tig
      // (+1) of the chunk), one value a word, then the kernel's packing
      int w[4][4];
      for (int jj = 0; jj < 4; ++jj) {
        const int k = 32 * ks + 8 * jj + 2 * tig;
        w[jj][0] = P[r0 * 128 + k];
        w[jj][1] = P[r0 * 128 + k + 1];
        w[jj][2] = P[(r0 + 8) * 128 + k];
        w[jj][3] = P[(r0 + 8) * 128 + k + 1];
      }
      a[ks][0] = low_bytes4(w[0][0], w[0][1], w[1][0], w[1][1]);
      a[ks][1] = low_bytes4(w[0][2], w[0][3], w[1][2], w[1][3]);
      a[ks][2] = low_bytes4(w[2][0], w[2][1], w[3][0], w[3][1]);
      a[ks][3] = low_bytes4(w[2][2], w[2][3], w[3][2], w[3][3]);
    } else {
      const int8_t* p0 = P + r0 * 128 + 32 * ks + 4 * tig;
      a[ks][0] = *reinterpret_cast<const uint32_t*>(p0);
      a[ks][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * 128);
      a[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
      a[ks][3] = *reinterpret_cast<const uint32_t*>(p0 + 8 * 128 + 16);
    }
  }
  int o[DP / 2];
  for (int i = 0; i < DP / 2; ++i) o[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs_s8<DP>(o, a[ks], wgmma_desc(smem_addr(smem) + ks * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
  for (int n = 0; n < DP / 8; ++n) {
    O[r0 * DP + 8 * n + 2 * tig] = o[4 * n];
    O[r0 * DP + 8 * n + 2 * tig + 1] = o[4 * n + 1];
    O[(r0 + 8) * DP + 8 * n + 2 * tig] = o[4 * n + 2];
    O[(r0 + 8) * DP + 8 * n + 2 * tig + 1] = o[4 * n + 3];
  }
}

template <int DP>
int run_s8_rs(const void* v, const void* P, void* O, int placed) {
  CUtensorMap tv;
  if (!s8_rows_map(&tv, v, DP, 128, DP)) return -1;
  const size_t smem = DP * 128 + 8 + 1024;
  cudaError_t e = allow_smem(probe_s8_rs_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  probe_s8_rs_kernel<DP><<<1, 128, smem>>>(tv, (const int8_t*)P, (int*)O, placed);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}

// v (DP, 128) and P (64, 128) int8; O (64, DP) int32 = P · vᵀ, with v's
// keys placed within 32-key chunks when `placed`
extern "C" int probe_s8_rs_run(int DP, const void* v, const void* P, void* O, int placed) {
  switch (DP) {
    case 32: return run_s8_rs<32>(v, P, O, placed);
    case 64: return run_s8_rs<64>(v, P, O, placed);
    case 96: return run_s8_rs<96>(v, P, O, placed);
    case 128: return run_s8_rs<128>(v, P, O, placed);
    case 160: return run_s8_rs<160>(v, P, O, placed);
    case 192: return run_s8_rs<192>(v, P, O, placed);
    case 224: return run_s8_rs<224>(v, P, O, placed);
    case 256: return run_s8_rs<256>(v, P, O, placed);
    default: return -2;
  }
}
