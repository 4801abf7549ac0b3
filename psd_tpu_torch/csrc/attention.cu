// attention_fwd: non-causal softmax(q·kᵀ·scale)·v, (B, S, H, D) bf16 in and
// out, fp32 logits and accumulators: the entry point psd_attention_fwd.
//
// Replaces psd_tpu/ops/spattn.py::_kernel (UNet self-attention, D = 40/80
// at S = 4096/1024) and the forward of JAX's stock Pallas flash kernel that
// psd_tpu/ops/flash.py::flash_attention wraps (the VAE mid block: one head,
// D = 512, S = 4096; and training's attention).
//
// The Pallas kernel keeps a whole K/V row resident in VMEM and takes one
// exact softmax; a block here has 227 KB of shared memory, so K/V stream
// through in tiles with an online softmax (running max m and sum l per query
// row, the accumulator rescaled by exp2(m_old − m_new) before each tile's
// P·V). Two warp-specialised kernels, fed by TMA through an mbarrier ring
// and running their products on wgmma, chosen by the padded head dim
// Dp = ceil16(D) (the notes in each file give their designs):
//  * Dp ≤ 160 (the UNet's 40/80): launch_narrow_attention in
//    attention_narrow.cu, two consumer warpgroups of 64 query rows, each
//    with its O in registers.
//  * Dp > 160 (the VAE's 512): launch_wide_attention in attention_wide.cu,
//    whose 64 × 512 O is split over two consumer warpgroups by columns.
// In both, as in spattn, the denominator sums the bf16-rounded probabilities
// that enter P·V, so the output is a convex combination of v rows; logits
// are scaled by scale·log2(e) in fp32 and exponentiated with exp2.
// When `lse` is not null (training asks for it), each query row's
// log-sum-exp in log2 units, m + log2(l), is written as fp32 (B, H, Sq) for
// the backward kernel (attention_bwd.cu); serving passes null.
// Requires D % 8 == 0; Sq, Sk multiples of 128 at Dp ≤ 160, of 64 above
// (the wrapper checks: ops/attention.py::fwd_shape_error).
#include "common.cuh"

namespace psd {

// attention_narrow.cu: the Dp <= 160 path
cudaError_t launch_narrow_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                    float* lse, int B, int Sq, int Sk, int H, int D,
                                    float scale_log2, cudaStream_t st);
// attention_wide.cu: the Dp > 160 path
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
  const cudaError_t err =
      D <= 160 ? launch_narrow_attention(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st)
               : launch_wide_attention(qp, kp, vp, op, lp, B, Sq, Sk, H, D, sl2, st);
  return static_cast<int>(err);
}
