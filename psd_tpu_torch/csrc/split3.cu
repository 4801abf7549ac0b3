// split3_fwd: gated triple-pathway cross-attention, (B, S, H, D) bf16.
//
//   out = g_anat·softmax(q·Kaᵀ·s)·Va + g_dis·softmax(q·Kdᵀ·s)·Vd
//       + δ·softmax(q·Kδᵀ·s)·Vδ
//
// Replaces psd_tpu/ops/split3.py::_kernel (every UNet cross-attention site
// with S ≥ 256 under split3 routing).
//
// What bounds it on the H100. Each bank holds at most 16 tokens, so per
// query row the work is 3·2·16·D multiply-adds for the logits and as many
// for P·V: at (8, 4096, 8, 40) that is 0.2 GFLOP against 2 × 21 MB of q in
// and out, ≈ 10 FLOP a byte. It is bound by reading q and writing out
// (≈ 13 µs at 3.35 TB/s): the design goal is to stream both at HBM rate.
//
// Design: a persistent kernel, one block an SM (sixteen warps where DP ≤
// 80, eight above, where a thread needs more than the 128 registers sixteen
// leave it), walking work items of R rows (64; fewer where shared memory is
// short) × a group of G heads of one batch element. Where one block an SM
// would get fewer than two items (and DP ≤ 80), two blocks of eight warps
// share the SM instead, each with half its shared memory, so that one
// block's launch, fill and drain run under the other's products (measured
// on an H100 at (8, 1024, 8, 80): 0.0146 against 0.0163 ms; at (8, 4096,
// 8, 40), four items a block, 0.0309 against 0.0285). The q columns of a
// group are contiguous in a row (G·D of H·D), so loads and stores move
// whole row segments: whole rows where G = H (D = 40), 640-byte segments at
// D = 80 (G = 4) and 160 (G = 2). A block takes a contiguous run of items,
// consecutive ones sharing (b, group), so it loads that group's six banks
// once per run into shared memory; all of one batch element's banks would
// not fit at D = 160 (6 × 16 × 1280 × 2 B = 240 KB), so G is the largest
// divisor of H whose banks and ring fit (ops/split3.py::split3_plan).
//  * Everything moves by TMA, issued by thread 0 (no producer warp: its
//    registers go to the compute warps): the item's q as 64-column boxes ×
//    R rows into a ring of ST stages, each completed on its full mbarrier;
//    each bank's group columns as 64-column boxes × its L rows, all six on
//    one mbarrier (≤ 30 boxes a run, where bulk copies of each 640-byte
//    bank row took 96 and measured 3–7 µs a run). Every box is 128-byte
//    swizzled (16-byte chunk j of row r at j ^ (r % 8)), so ldmatrix and
//    the fragment loads are free of bank conflicts; columns past H·D read
//    as zeros; bank rows past L are zeroed once at the start.
//  * A warp takes (16 rows, one head) units of the item and keeps the old
//    kernel's arithmetic: q's A fragments by ldmatrix from the stage (a
//    head's columns need not start at a box; where D % 16 == 8 the last
//    k16 step's upper half is zeroed, not read from the next head, so the
//    K columns past the head add nothing); logits against all 48 keys as
//    one mma.sync m16n8k16 product (bank i at keys 16i..); an exact softmax
//    for each bank over its valid keys (exp2, scale·log2e folded in),
//    scaled by its gate (g_anat, g_dis or δ) before rounding to bf16, so
//    the gated sum is one product P'·[Va; Vd; Vδ] with V's fragments by
//    ldmatrix.trans. The unit writes its bf16 output over its own q in the
//    stage.
//  * When the warps are done with an item (__syncthreads after each
//    thread's proxy fence), thread 0 stores the stage by TMA (elements past
//    H·D are not written) and, once the previous item's stores have read
//    their stage, refills that stage with the item ST − 1 ahead: the stores
//    run under the next item's loads and products.
// mma.sync suffices at 48 keys: a 16-row unit is the natural grain of the
// per-bank softmax, and wgmma's 64-row tiles would buy no bytes.
// The gates and δ are plain arguments: changing the steering scale rebuilds
// nothing. Requires bank lengths 1..16, D % 8 == 0, 24 ≤ D ≤ 160, S % R ==
// 0 and a plan that fits (the wrapper checks).
#include "common.cuh"
#include "hopper.cuh"

namespace psd {
namespace {

using namespace hopper;

// warps of the kernel for padded head dim DP, NB blocks an SM
__host__ __device__ constexpr int kernel_warps(int DP, int NB) {
  return NB == 2 ? 8 : DP <= 80 ? 16 : 8;
}
constexpr int kMaxStages = 4;
// a block's shared memory: all an SM offers one block, or half of the SM's
// 233472 bytes less the 1024 each block reserves
constexpr size_t kSmemMax[2] = {232448, 115712};

// q and out, then the six banks (ka, va, kd, vd, kl, vl), for TMA from the
// kernel's parameter space
struct Maps {
  CUtensorMap q, out, bank[6];
};

struct Split3Args {
  int len[3];
  float gate[3];
};

// A ring stage: the item's q, ceil(G·D / 64) boxes of R rows × 128 bytes.
__host__ __device__ inline uint32_t stage_bytes(int R, int G, int D) {
  return static_cast<uint32_t>((G * D + 63) / 64) * R * 128;
}
// The banks: six of ceil(G·D / 64) boxes of 16 rows × 128 bytes.
__host__ __device__ inline uint32_t bank_bytes(int G, int D) {
  return static_cast<uint32_t>(6 * ((G * D + 63) / 64)) * 16 * 128;
}
// The ring, the banks, 8 bytes of mbarrier a stage and the banks' one, and
// the slack to align the ring to 1024 bytes
inline size_t smem_bytes(int R, int G, int ST, int D) {
  return static_cast<size_t>(ST) * stage_bytes(R, G, D) + bank_bytes(G, D) + 8 * ST + 8 + 1024;
}

// Byte offset, from its row's start in the first box, of the row's 16-byte
// chunk c (columns 8c .. 8c + 7) in `rows`-row boxes of 64 columns,
// 128-byte swizzled, for a row with row % 8 == x (chunk j of the box at
// j ^ x; x < 8 leaves the box index c / 8 unchanged).
__device__ __forceinline__ uint32_t swz(int c, int x, int rows) {
  return ((c ^ x) >> 3) * rows * 128 + (((c ^ x) & 7) << 4);
}

template <int DP, int NB>
__global__ void __launch_bounds__(32 * kernel_warps(DP, NB), NB)
split3_kernel(const __grid_constant__ Maps maps, const Split3Args a, int B, int S, int H, int D,
              int R, int G, int ST, float scale_log2) {
  constexpr int NO = DP / 8, KS = DP / 16, kWarps = kernel_warps(DP, NB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbytes = stage_bytes(R, G, D);
  const int n_box = (G * D + 63) / 64, n_rb = S / R, n_g = H / G;
  const uint32_t bank_stride = n_box * 16 * 128;  // one bank's boxes
  unsigned char* banks = smem + ST * sbytes;      // [ka, va, kd, vd, kl, vl][n_box][16][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(banks + bank_bytes(G, D));
  uint64_t* bank_full = full + ST;  // a run's banks have arrived
  const int len[3] = {a.len[0], a.len[1], a.len[2]};
  const int n_items = B * n_g * n_rb;
  // this block's run of items, (b, group) outermost, then the row block
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * n_items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_items / gridDim.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // item it's q boxes into stage s, on the stage's full mbarrier
  auto load_item = [&](int it, int s) {
    const int run = it / n_rb;
    mbar_arrive_expect_tx(&full[s], sbytes);
    for (int j = 0; j < n_box; ++j)
      tma_load_3d(smem + s * sbytes + j * R * 128, &maps.q, &full[s],
                  (run % n_g) * G * D + 64 * j, 0, (run / n_g) * S + (it % n_rb) * R);
  };
  // the six banks' group columns of the run's batch element, rows 0 .. L − 1
  auto load_banks = [&](int run) {
    const int b = run / n_g, c0 = (run % n_g) * G * D;
    mbar_arrive_expect_tx(bank_full, 2 * (len[0] + len[1] + len[2]) * n_box * 128);
#pragma unroll
    for (int t = 0; t < 6; ++t)
      for (int j = 0; j < n_box; ++j)
        tma_load_3d(banks + t * bank_stride + j * 16 * 128, &maps.bank[t], bank_full,
                    c0 + 64 * j, 0, b * len[t / 2]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    mbar_init(bank_full, 1);
    mbar_fence_init();
    load_banks(i0 / n_rb);
    for (int it = i0; it < i1 && it < i0 + ST; ++it) load_item(it, it - i0);
  }
  // while they fly, zero the bank rows past each bank's length, which no
  // copy writes (V's meet P = 0; K's are masked, and read only as the
  // padding columns of a head where D % 16 == 8)
  for (int p = warp; p < 6 * n_box; p += kWarps) {
    const int t = p / n_box, L = t < 2 ? len[0] : t < 4 ? len[1] : len[2];
    for (int c = lane; c < (16 - L) * 8; c += 32)
      *reinterpret_cast<uint4*>(banks + p * 16 * 128 + L * 128 + c * 16) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int g = lane >> 2, tig = lane & 3;
  const int units = (R / 16) * G;
  int staged = i0 / n_rb, n_runs = 0;  // the (b, group) run whose banks are loaded; runs before it
  for (int it = i0, seq = 0; it < i1; ++it, ++seq) {
    const int run = it / n_rb, b = run / n_g, grp = run % n_g;
    if (run != staged) {
      // every warp has passed the previous item's barrier, so no one reads
      // the old banks any more
      if (threadIdx.x == 0) {
        fence_async_shared();
        load_banks(run);
      }
      staged = run;
      ++n_runs;
    }
    if (it == i0 || run != (it - 1) / n_rb) mbar_wait(bank_full, n_runs & 1);
    const int s = seq % ST;
    mbar_wait(&full[s], (seq / ST) & 1);
    unsigned char* sp = smem + s * sbytes;
    const uint32_t sa = smem_addr(sp), ba = smem_addr(banks);

    for (int u = warp; u < units; u += kWarps) {
      const int rg = u % (R / 16), hl = u / (R / 16);
      const int c8 = hl * D / 8;  // the head's first 16-byte chunk in the item's rows
      // logits against all 48 keys: n-tiles 2i, 2i+1 belong to bank i. A
      // per k16 step: q's fragment by ldmatrix from the stage (lanes 0-15
      // rows 0-15 at the step's columns 0-7, lanes 16-31 the same at 8-15);
      // B: K row 8·(j % 2) + g, columns 2·tig (+1) and those + 8
      float sc[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const uint32_t qrow = sa + (rg * 16 + (lane & 15)) * 128;
      const uint32_t krow = ba + g * 128 + 4 * tig;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bool pad = ks * 16 + 8 >= D;  // the step's upper half is past the head
        uint32_t qa[4];
        ldmatrix_x4(qa, qrow + swz(c8 + 2 * ks + (pad ? 0 : lane >> 4), lane & 7, R));
        if (pad) qa[2] = qa[3] = 0u;
        const uint32_t k0 = krow + swz(c8 + 2 * ks, g, 16), k1 = krow + swz(c8 + 2 * ks + 1, g, 16);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const uint32_t kj = (j / 2) * 2 * bank_stride + (j % 2) * 8 * 128;
          mma_bf16(sc[j], qa, ld_shared_u32(k0 + kj), ld_shared_u32(k1 + kj));
        }
      }

      // per bank: exact softmax over its keys, scaled by its gate, as A fragments
      uint32_t pa[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int L = len[i];
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* sj = sc[2 * i + t];
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
            float* sj = sc[2 * i + t];
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
        const float f0 = __fdividef(a.gate[i], sum0), f1 = __fdividef(a.gate[i], sum1);
        pa[i][0] = pack_bf16x2(sc[2 * i][0] * f0, sc[2 * i][1] * f0);
        pa[i][1] = pack_bf16x2(sc[2 * i][2] * f1, sc[2 * i][3] * f1);
        pa[i][2] = pack_bf16x2(sc[2 * i + 1][0] * f0, sc[2 * i + 1][1] * f0);
        pa[i][3] = pack_bf16x2(sc[2 * i + 1][2] * f1, sc[2 * i + 1][3] * f1);
      }

      // out = [g_a·P_a | g_d·P_d | δ·P_δ] · [Va; Vd; Vδ] (V's fragments by
      // ldmatrix.trans: lanes 0-15 give key rows 0-15), written over the
      // unit's q in the stage (rows g and g + 8, columns 8n + 2·tig (+1))
      float o[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      const uint32_t vrow = ba + bank_stride + (lane & 15) * 128;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n * 8 >= D) continue;  // past the head (D % 16 == 8), maybe past the banks
        const uint32_t vn = vrow + swz(c8 + n, lane & 7, 16);
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          uint32_t bv[2];
          ldmatrix_x2_trans(bv, vn + 2 * kk * bank_stride);
          mma_bf16(o[n], pa[kk], bv[0], bv[1]);
        }
      }
      const uint32_t orow = sa + (rg * 16 + g) * 128 + 4 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n * 8 < D) {
          const uint32_t on = orow + swz(c8 + n, g, R);
          st_shared_u32(on, pack_bf16x2(o[n][0], o[n][1]));
          st_shared_u32(on + 8 * 128, pack_bf16x2(o[n][2], o[n][3]));
        }
      }
    }

    // the item's output is in the stage: store it by TMA; once the previous
    // item's stores have read their stage, refill that stage
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_box; ++j)
        tma_store_3d(&maps.out, sp + j * R * 128, grp * G * D + 64 * j, 0,
                     b * S + (it % n_rb) * R);
      bulk_commit();
      if (seq > 0 && it - 1 + ST < i1) {
        bulk_wait_read<1>();
        load_item(it - 1 + ST, (seq - 1) % ST);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();  // the stages outlive their stores
}

template <int DP, int NB>
cudaError_t launch(const bf16* q, const bf16* const (&bank)[6], bf16* out, const Split3Args& a,
                   int B, int S, int H, int D, int R, int G, int ST, float scale,
                   cudaStream_t st) {
  if (B <= 0 || (R != 16 && R != 32 && R != 64) || S <= 0 || S % R != 0 || G <= 0 ||
      H % G != 0 || (G != H && (G * D) % 64 != 0) || ST < 2 || ST > kMaxStages ||
      sm_count() == 0)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(R, G, ST, D);
  if (bytes > kSmemMax[NB - 1]) return cudaErrorInvalidValue;
  Maps maps;
  if (!bf16_rows_map(&maps.q, q, B * S, 1, H * D, R) ||
      !bf16_rows_map(&maps.out, out, B * S, 1, H * D, R))
    return cudaErrorInvalidValue;
  for (int t = 0; t < 6; ++t)
    if (!bf16_rows_map(&maps.bank[t], bank[t], B * a.len[t / 2], 1, H * D, a.len[t / 2]))
      return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(split3_kernel<DP, NB>, bytes);
  if (err != cudaSuccess) return err;
  const int n_items = B * (H / G) * (S / R);
  split3_kernel<DP, NB><<<std::min(n_items, NB * sm_count()), 32 * kernel_warps(DP, NB), bytes,
                          st>>>(maps, a, B, S, H, D, R, G, ST, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_nb(const bf16* q, const bf16* const (&bank)[6], bf16* out,
                      const Split3Args& a, int B, int S, int H, int D, int R, int G, int ST,
                      int NB, float scale, cudaStream_t st) {
  if (NB == 1) return launch<DP, 1>(q, bank, out, a, B, S, H, D, R, G, ST, scale, st);
  if constexpr (DP <= 80) {
    if (NB == 2) return launch<DP, 2>(q, bank, out, a, B, S, H, D, R, G, ST, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace psd

extern "C" int psd_split3_fwd(const void* q, const void* ka, const void* va,
                              const void* kd, const void* vd, const void* kl,
                              const void* vl, void* out, int B, int S, int H, int D,
                              int Ka, int Kd, int Kl, float g_anat, float g_dis,
                              float delta, float scale, int R, int G, int ST, int NB,
                              void* stream) {
  using namespace psd;
  const Split3Args a{{Ka, Kd, Kl}, {g_anat, g_dis, delta}};
  const bf16* const banks[6] = {static_cast<const bf16*>(ka), static_cast<const bf16*>(va),
                                static_cast<const bf16*>(kd), static_cast<const bf16*>(vd),
                                static_cast<const bf16*>(kl), static_cast<const bf16*>(vl)};
  const bf16* qp = static_cast<const bf16*>(q);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 32:
      return static_cast<int>(
          launch_nb<32>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 48:
      return static_cast<int>(
          launch_nb<48>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 64:
      return static_cast<int>(
          launch_nb<64>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 80:
      return static_cast<int>(
          launch_nb<80>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 96:
      return static_cast<int>(
          launch_nb<96>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 112:
      return static_cast<int>(
          launch_nb<112>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 128:
      return static_cast<int>(
          launch_nb<128>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 144:
      return static_cast<int>(
          launch_nb<144>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    case 160:
      return static_cast<int>(
          launch_nb<160>(qp, banks, op, a, B, S, H, D, R, G, ST, NB, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
