"""psd_tpu_torch — DADD serving (exact and turbo) and training in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

A port of `psd_tpu` (JAX on a TPU), which stays beside it as the reference.
This package imports neither JAX nor `psd_tpu`. Layouts at the public
functions follow `psd_tpu`: NHWC images and latents, (B, S, H, D) attention
operands. Compute runs in the model's dtype (bf16 on the GPU, fp32 in the
CPU tests) with fp32 sampler state; parameters are fp32 except the UNet's
and VAE decoder's matmul/conv weights, which DADD stores in the compute dtype
they are always used in (and the int8 VAE decoder's int8 conv weights, which
it computes once from the fp32 values).
"""

__version__ = "0.1.0"
