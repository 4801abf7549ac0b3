#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile psd_tpu_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
               per source, all at once; print ptxas's registers, stack and
               spills for the attention forward kernels (kept in the kernels
               line only when this run ran nvcc), for the backward's dQ
               and dK/dV kernels, the LayerNorm and GroupNorm GEMM kernels
               (gn_proj's Kind::kGn among them), the attention_q8 kernels
               (each padded head dim, both modes) and the split3 kernels
               (printed only).
  3. kernels — each kernel against its plain PyTorch version at
               every shape the 512², batch-8 serving path gives it (bf16,
               seeded inputs): relative L2 error against stated bands
               (psd_tpu_torch.testing's judges; max abs/rel error printed);
               kernel, plain and (where one PyTorch call computes the same
               function) library time (CUDA events, median of 10 after
               warm-up); and the bound, the least time the card could take
               (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s bf16,
               whichever is larger). The attention kernels are held to
               relative L2 bands over the output and each query row: at
               D=40/80 (the UNet, attention_narrow.cu, also timed with
               the log-sum-exp at training's (64,1024,8,40), a reading kept
               apart from the entry's sums) and at D=512 (the VAE mid
               block, attention_wide.cu); their log-sum-exp to
               lse_reference; printed beside their bound, not kept, the
               exp2 count's time at the SFU rate; untimed edge shapes
               (every padded head dim of each kernel, H of 1 and 3,
               Sq != Sk). ln_proj (3 and 1 outputs) and ln_geglu by
               relative L2 over each output and each row
               (ln_gemm_judge), with printed yardsticks beside each shape
               (not kept): the device time of one call (CUDA-graph
               replay), the cuBLAS product of the same size alone and the
               wrapper's host time; untimed edge inputs (rows of large
               mean at every LN_SHAPES entry, C = 64, 192, 448, N = 200).
               split3 (relative L2 over the output and each query row,
               split3_judge) and gn_proj (the same over each row,
               gn_proj_judge), each with the device time of one call
               (CUDA-graph replay) and the wrapper's host time printed
               beside the eager time; untimed edge inputs (split3: unequal
               banks of 1..16 tokens, D = 24, 64, 160, H = 1 and 3, S =
               384, B = 1 and 3, δ = 0 and −1.5; gn_proj: half-full last
               row tiles, N = 200, channel means of std 8 folded into the
               affine).
               attention_q8
               (int8 spatial attention, both modes) at the UNet
               self-attention shapes psd_tpu's spatial_attention accepts,
               against its plain version with exact integer products
               (relative L2 of the output and of each query row,
               attention_q8_judge), with the device time of one call
               (CUDA-graph replay), the wrapper's host time and the
               design's quarter-rate operations at the exp2 rate printed
               beside (not kept); untimed edge shapes (every padded head
               dim 32..256, H = 1 and 3, S = 256 and 768, both modes); a tie
               probe that tells rounding half to even from half away; int8
               products bound at 1979 TOPS; beside it the bf16 attention
               kernel's time.
  3b. op     — psd_tpu_torch.ops.attention.spatial_attention(quant=...) at
               those shapes: the op path that reaches attention_q8, as
               scripts/bench_attn2.py drives psd_tpu's (6 launches); the
               op's time, the kernel's alone and the quantization
               pre-pass's, printed.
  4. unet    — one SD-scale UNet eps (split3, seeded flax-style init, bf16,
               latents (8, 64, 64, 4), 48 tokens, δ=1) on the kernels and
               with the plain versions forced: relative error; then eps time
               with gn_proj on and off in 10 alternating pairs (host clock:
               wall and enqueue, medians and quartiles); then the eps's
               device time (captured in a CUDA graph, replayed) on the
               kernels, with the LN kernels off and all plain.
  5. serve   — a GenerationServer over the SD-scale DADD at 512², 50 DDIM
               steps, max_batch 8, steer 1.0 answers 8 requests by CUDA-graph
               replay (the default: one captured program a batch, sampler
               loop and decode); images are checked, every serving kernel
               launched, and the program's capture launches exactly what a
               batch does (attention 501, split3 750, ln_proj 1600, ln_geglu
               800, gn_proj 800; the host counts are the eager warm-up's and
               the capture's, a replay adds none). Then: the same batch
               replayed again; 16 requests at pipeline_depth=2, each batch
               led by its own seed, two batches in flight; every image equal
               bit for bit to the eager run (core.mode.eager()) of the same
               requests; one batch with fused=False (two replays, sample then
               decode_latents) equal to fused=True's; the A/B of graphs
               against eager in AB_PAIRS alternating pairs (wall, host
               dispatch, peak memory); each program's warm-up, capture and
               instantiation seconds; one replay's device time and host
               launch time against 50 × the eps's device time (phase 4) + the
               decode; and, in a child process, a capture that fails (a host
               sync in the VAE) raises, keeps no program and runs nothing
               eagerly in its place.
  5b. turbo  — the same at the turbo point (TURBO: DPM-Solver++(2M), 25
               steps, DeepCache stride 5, int8 VAE) by graph replay: images
               checked and equal to the eager run's, 6 full and 19 shallow
               UNet evaluations at warm-up and at capture (none at replay, as
               many eagerly), the capture launching attention 156, split3
               185, ln_proj 382, ln_geglu 191, gn_proj 191; the A/B of graphs
               against eager; wall time beside phase 5's. Then the int8
               against the bf16 VAE decode of the same seeded latents with
               the same weights (PSNR floor, max abs diff, ms each), and
               qconv3x3 against an exact fp64 conv at one decoder shape.
  5c. infer  — the MES progression CLI (psd_tpu_torch.pipelines.infer.main)
               on the card, eagerly as the CLI runs: (a) the README's command
               at 512² (configs/train_ip.yaml, 13 levels, steer 1.0; CLIP
               ViT-L/14 last_hidden_state → IP-Plus → purifier → split3, 50
               DDIM steps, bf16 VAE) on a seeded synthetic structure PNG;
               (b) baseline mode (configs/train.yaml at 256²: CLIP
               image_embeds → ImageProjection → LEACE → split2, CFG 3.0
               against the negative AOE at a UNet batch of 26, eta 0.5) with
               a LEACE npz fitted in the phase. Each run: 13 finite images in
               [0, 1], the files written, each kernel's launches equal to
               what the routes give the batch (psd_tpu_torch.testing.
               route_launches: at batch 13 the LN kernels skip the 16² and 8²
               levels), the CLIP tower's bf16 features against the same tower
               in fp32 (CLIP_REL_BAND); in (a) one batch-13 eps on the CLI's
               conditioning, kernels against all plain (UNET_REL_BAND). Then
               each kernel against its plain version by its judge at the
               path's batch-13 and batch-26 shapes (INFER_*; not timed).
               Printed: the CLI's phase times, its time and main()'s wall
               with the model's build, peak memory, the card.
  6. train   — the attention backward kernel against autograd through the
               plain version at the training shapes, by relative L2 over
               each of dQ, dK, dV and each of their rows
               (attention_bwd_judge), timed beside SDPA's backward alone
               (library) and fwd+bwd, with the exp2 count's time printed
               beside the bound; untimed edge shapes at every padded head
               dim; split3's autograd.Function against the plain version at
               the training shapes; then the SD-scale train step of
               configs/train_ip.yaml (256², batch 64, fp32
               masters, bf16 compute, gradient checkpointing, AdamW in two
               LR groups, EMA from step 0) takes 3 steps on seeded random
               pre-encoded batches; loss and gradients on the kernels are
               held against the plain versions with the same draws, the
               flattened gradient and, on their own, the q/k/v weight
               gradients of the self-attention sites the kernel serves.
  6b. train_cli — the training CLI (psd_tpu_torch.pipelines.train.main,
               in-process) on a seeded synthetic tree of 128 train and 32
               val PNGs of 288 × 352 in four class directories, at
               configs/train_ip.yaml's full width (256², batch 64, fp32
               masters): run 1 takes two steps from the PNGs (the LIMUC
               loader, the frozen VAE encoder and CLIP encode of each
               batch), saves the epoch's checkpoint and validates on the
               EMA (the val loss over one batch, a 4-level grid of 10
               steps); run 2 resumes from "last" for a third step (the
               restored parameters, moments, counts, EMA and generator held
               to the files bit for bit, as the saved state was to run 1's)
               and saves it; run 3 is the infer CLI on the checkpoint's EMA
               at 256². Each run's launches, counted from 0, equal phase
               6's per step for each step, one attention launch at D = 512
               for each encoded batch, `route_launches` of the val loss's
               batch-64 forward (no decode) and of the grid (batch 4, 10
               steps, its decode); then each kernel against its plain
               version by its judge at this path's new shapes (TRAIN_CLI_*,
               not timed). Prints each step's phases (data, encode,
               train_step), the logged img/s beside phase 6's, each save's
               and the restore's GB and seconds, free disk, peak memory,
               the card. Its files are deleted at the end.
The line before the last is a JSON object with one entry per kernel:
`launches` counts the launches of the main-path runs (phases 3b, 5, 5b, 5c,
6 and 6b, each with the counts set to 0 just before it, 5c before each of
its two CLI runs, 6b before each of its three; `launches_by_path` splits them; in phases 5 and 5b the wrappers run, and count, at the eager warm-up
and at the capture of the batch's program, and `launches_per_replay` gives
what one replay launches),
`max_abs_err` is the largest over the kernel's shapes, `ms`, `plain_ms`,
`library_ms` and `bound_ms` sum one call at each of its main-path shapes
(attention_bwd's `library_ms` is SDPA's backward alone, on a retained
graph; `fwd_bwd_ms` and `sdpa_fwd_bwd_ms` are the two fwd+bwd readings).
The last line is the device JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "psd_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: psd_tpu_torch/ is missing; run from a checkout of the repo")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# bf16 band for phase 6's gradients against autograd through the plain
# versions (_grad_compare; split3's autograd.Function): both round their
# inputs, probabilities and outputs to bf16 at different points (2^-8
# relative each), and sum in different orders. Every kernel's own output is
# held by relative L2 instead (psd_tpu_torch.testing's judges).
ATOL, RTOL = 1e-2, 1e-2
# UNet eps on the kernels vs with the plain versions forced: ~150 bf16
# layers, each rounding differently; relative L2 error.
UNET_REL_BAND = 5e-2
# one train_loss + backward on the kernels vs the plain versions with the
# same draws and weights. In training only attention (S >= 512) and split3
# take kernels, so the two runs differ by those sites' bf16 rounding alone:
# the loss (relative) and the flattened gradient (relative L2), and, on their
# own, the attn1 q/k/v weight gradients at the S = 1024 sites, which the
# attention backward kernel alone feeds (relative L2, the largest of the 15
# leaves); a wrong backward there is a small share of the 920 M entries of
# the flattened gradient. The gradient bands sit between the sound run's
# reading (4.0e-3 flattened, 5.6e-3 leaves; deterministic) and those of
# planted faults in the attention backward (flattened 3.2e-2 for lse + 0.1;
# leaves 1.9e-2 for lse + 0.02, 1.3e-1 for a dQ pass that skips its last key
# tile; PERF.md). The loss is the forward's alone: 10x its reading, 3.2e-5.
TRAIN_LOSS_BAND, TRAIN_GRAD_BAND, ATTN1_LEAF_BAND = 5e-4, 1e-2, 1e-2
# the attn1 sites on the attention kernel at 256² (32×32 latents, S = 1024):
# 2 in down_blocks_0, 3 in up_blocks_3, one backward launch each a step
ATTN1_SITES = 5
ATTN1_LEAF = re.compile(r"unet\.(down_blocks_0|up_blocks_3)_attentions_\d+\.transformer_blocks_0"
                        r"\.attn1\.to_[qkv]\.weight")
GN_AB_PAIRS = 10

# kernel → (TPU kernel it replaces as file:line, CUDA source)
KERNELS = {
    "attention": ("psd_tpu/ops/spattn.py:36", "psd_tpu_torch/csrc/attention_narrow.cu"),
    "attention_bwd": ("psd_tpu/ops/flash.py:121", "psd_tpu_torch/csrc/attention_bwd.cu"),
    "split3": ("psd_tpu/ops/split3.py:29", "psd_tpu_torch/csrc/split3.cu"),
    "ln_proj": ("psd_tpu/ops/geglu.py:178", "psd_tpu_torch/csrc/ln_proj.cu"),
    "ln_geglu": ("psd_tpu/ops/geglu.py:73", "psd_tpu_torch/csrc/ln_geglu.cu"),
    "gn_proj": ("psd_tpu/ops/gnproj.py:44", "psd_tpu_torch/csrc/gn_proj.cu"),
    "attention_q8": ("psd_tpu/ops/spattn.py:66", "psd_tpu_torch/csrc/attention_q8.cu"),
}
SERVE_KERNELS = ("attention", "split3", "ln_proj", "ln_geglu", "gn_proj")
# the attention kernel's sources: psd_attention_fwd (attention.cu) dispatches
# D <= 160 to attention_narrow.cu and wider heads to attention_wide.cu
ATTN_SOURCES = ["psd_tpu_torch/csrc/attention.cu", "psd_tpu_torch/csrc/attention_narrow.cu",
                "psd_tpu_torch/csrc/attention_wide.cu"]
# the attention kernel also takes the stock Pallas flash kernel's forward;
# attention_bwd is that kernel's dq/dkv backward
ALSO_REPLACES = {"attention": "psd_tpu/ops/flash.py:121 (jax.experimental.pallas.ops."
                              "tpu.flash_attention, forward; psd_tpu_torch/csrc/"
                              "attention_narrow.cu at D <= 160, attention_wide.cu above)",
                 "attention_bwd": "jax.experimental.pallas.ops.tpu.flash_attention "
                                  "(dq and dkv backward kernels, configured at "
                                  "psd_tpu/ops/flash.py:104-121)"}

# shapes on the 512², batch-8 main path (SD-v1.4 UNet, 8 heads; VAE mid)
ATTN_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 4096, 1, 512)]
# training's forward (256², batch 64), timed with the log-sum-exp it asks for
ATTN_LSE_SHAPES = [(64, 1024, 8, 40)]
# the narrow path at every padded head dim it is built for (32, 48, 64, 80,
# 96, 128, 160; D below Dp by TMA's zero fill), one or three heads, Sq != Sk
# ((B, Sq, H, D), Sk; not timed)
ATTN_NARROW_EDGE_SHAPES = [((1, 512, 3, 24), 1536), ((2, 256, 1, 40), 384),
                           ((1, 512, 3, 64), 1536), ((2, 256, 1, 72), 384),
                           ((1, 512, 3, 96), 1536), ((2, 256, 1, 104), 384),
                           ((1, 512, 3, 136), 1536), ((2, 256, 1, 160), 384)]
# the wide-head path at shapes the main path does not give it: D below 512
# (TMA's zero fill), several heads, Sq != Sk ((B, Sq, H, D), Sk; not timed)
ATTN_WIDE_EDGE_SHAPES = [((2, 256, 2, 264), 512), ((1, 128, 3, 384), 128),
                         ((2, 192, 1, 448), 320)]
SPLIT3_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
# untimed split3 edge inputs, ((B, S, H, D), bank lengths, δ): unequal
# banks of 1..16 tokens, D = 24, 64, 160, H = 1 and 3 (a group of all the
# heads whose last box runs past H·D), S = 384, B = 1 and 3, δ = 0 and −1.5,
# and the main path's H = 8 at D = 40 and 80 with short banks
SPLIT3_EDGE = [((1, 384, 3, 24), (1, 4, 15), 0.0), ((3, 384, 1, 64), (15, 1, 4), -1.5),
               ((1, 384, 3, 160), (4, 15, 1), -1.5), ((3, 256, 1, 160), (16, 4, 15), 0.0),
               ((3, 384, 3, 64), (4, 16, 1), 0.0), ((1, 384, 8, 40), (4, 16, 7), -1.5),
               ((2, 256, 8, 80), (15, 1, 16), 0.0)]
LN_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]
# untimed LN edge inputs, (M, C, N of ln_proj, N of ln_geglu): C at 64, 192
# and 448 (ln_proj's one-output 160-column tile ragged at each), and N not a
# multiple of any tile (TMA's zero fill, masked stores); plus every
# LN_SHAPES entry with rows of a large mean (LN_EDGE_MEAN_STD)
LN_EDGE_SHAPES = [(512, 64, 64, 256), (512, 192, 192, 768), (512, 448, 448, 1792),
                  (1024, 192, 200, 200)]
# each edge row's x gets an offset of this std (x + 8·N(0,1) a row)
LN_EDGE_MEAN_STD = 8.0
GN_SHAPES = [(8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (8, 64, 1280)]
# untimed gn_proj edge inputs, (B, S, C, N): a generate call of batch 1 or 3
# at 512² (B·S % 128 == 64 at the mid block: the kernel's half-full last row
# tile), and N not a multiple of the kernel's 160-column tile; plus every
# GN_SHAPES entry with channel means of std GN_EDGE_MEAN_STD folded into the
# affine (x·w + b then cancels in fp32)
GN_EDGE_SHAPES = [(1, 64, 1280, 1280), (3, 64, 1280, 1280), (3, 192, 640, 640),
                  (3, 64, 320, 200)]
GN_EDGE_MEAN_STD = 8.0
# training: 256², batch 64 (configs/train_ip.yaml); the 512² routes too
ATTN_BWD_SHAPES = [(64, 1024, 8, 40), (8, 4096, 8, 40), (8, 1024, 8, 80)]
SPLIT3_TRAIN_SHAPES = [(64, 1024, 8, 40), (64, 256, 8, 80)]
TRAIN_STEPS, TRAIN_BATCH = 3, 64
# int8 spatial attention: the UNet self-attention shapes psd_tpu's
# spatial_attention accepts at 512², batch 8 (S % 256 == 0, S <= 4096)
Q8_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
Q8_MODES = ("qk8", "int8")
# untimed attention_q8 edge shapes, both modes: every padded head dim the
# kernel is built for (Dp = 32..256, D below Dp except at 256), one or three
# heads, S = 256 and 768 (three key tiles of 128, not a power of two)
Q8_EDGE_SHAPES = [(1, 256, 3, 24), (1, 768, 1, 56), (1, 256, 3, 88), (1, 768, 1, 120),
                  (1, 256, 3, 152), (1, 768, 1, 184), (1, 256, 3, 216), (1, 768, 1, 256)]
# the operations a logit the kernel's design runs on the SFU at exp2's rate
# (16 a clock on each SM): one exp2 in "qk8", two in "int8" (the divisions
# and the rounding run on the full-rate pipes; its I2F and bf16 packing
# measured faster than that rate on an H100, PERF.md §6 PR 10); printed at
# the exp2 rate beside the bound, not kept
Q8_QUARTER_RATE_OPS = {"qk8": 1.0, "int8": 2.0}
# The tie probe (int8 mode): rows with two live keys, the row max and one
# key whose pn/ps is k + 1/2 (k even) or near it, where rounding half to even
# and half away from zero differ by one level, 1/k of the output (k <= 62).
# l is then a sum of two terms, the same in any order, so the kernel and the
# plain version compute the same fp32 values and must agree elementwise to
# one bf16 ulp, 2^-7·|ref|. MIN_TIES exact ties must occur for the probe to
# count.
Q8_PROBE_SHAPE, Q8_PROBE_TIES = (2, 4096, 8, 40), tuple(k + 0.5 for k in range(4, 63, 2))
Q8_PROBE_MIN_TIES = 32

# the turbo serving point, a copy of bench.py's TURBO (bench.py imports JAX);
# tests/test_torch_turbo.py holds the two equal. The port has no ToMe: its
# ratio must stay 0.
TURBO = dict(tome_ratio=0.0, tome_mode="branch",
             encoder_stride=5, cache_mode="deep",
             sampler="dpm", steps=25, vae_quant="int8")
# DPM steps i with i % stride == 0 or i == steps - 1 run the full UNet
TURBO_FULL = sum(1 for i in range(TURBO["steps"])
                 if i % TURBO["encoder_stride"] == 0 or i == TURBO["steps"] - 1)
TURBO_SHALLOW = TURBO["steps"] - TURBO_FULL
# what one served batch of 8 at 512² launches (PERF.md §6): the exact path
# (50 DDIM steps) and the turbo point; a captured program must launch these
SERVE_LAUNCHES = {"attention": 501, "split3": 750, "ln_proj": 1600, "ln_geglu": 800,
                  "gn_proj": 800}
TURBO_LAUNCHES = {"attention": 156, "split3": 185, "ln_proj": 382, "ln_geglu": 191,
                  "gn_proj": 191}
# served batches timed with and without graphs, in alternating pairs
AB_PAIRS = 4
# int8 vs bf16 VAE decode of the same latents (8, 64, 64, 4), same weights
# with spread channel gains: PSNR floor in dB, between the sound reading
# (37.19) and a planted per-tensor weight scale's (36.69; deterministic,
# PERF.md §6). Activation quantization dominates the int8 error, so the
# gap is narrow at any spread (0.5-0.7 dB at gains 2^±2..2^±4); the scales
# are also checked directly.
VAE_PSNR_FLOOR = 36.95
# the spread: per-output-channel gains 2^u, u ~ U(-VAE_GAIN_LOG2, VAE_GAIN_LOG2)
VAE_GAIN_LOG2 = 2.0
# qconv3x3 on the card (nine int8 GEMMs, int32 sums) against an fp64 conv of
# the same integer operands, at the decoder's first resblock shape
QCONV_CHECK_SHAPE, QCONV_REL_BAND = (1, 64, 64, 512), 1e-5

# the infer phase: the MES progression CLI as the README runs it (13 levels,
# steer 1.0) at the served resolution, then baseline mode with CFG, eta and
# LEACE at configs/train.yaml's 256²
INFER_LEVELS = 13
INFER_RUN_A = ["--config", "configs/train_ip.yaml", "--image-size", "512", "--mes-steps",
               str(INFER_LEVELS), "--steer-scale", "1.0", "--seed", "0"]
INFER_RUN_B = ["--config", "configs/train.yaml", "--mes-steps", str(INFER_LEVELS),
               "--guidance-scale", "3.0", "--eta", "0.5", "--seed", "0"]
# the CLIP ViT-L/14 tower's bf16 features (the CLI's) against the same tower
# in fp32 on the same pixels, relative L2 over the whole output: bf16
# activations and weights through 24 pre-LN layers. On an NVIDIA H100 80GB
# HBM3 (700 W) the sound tower reads 1.117e-2 (last_hidden_state, run a) and 1.113e-2
# (image_embeds, run b) on its seeded weights and the synthetic structure
# image (PERF.md §5, PR 12); the band leaves 2.7x that
CLIP_REL_BAND = 3e-2
# LEACE fitted in the phase on seeded image tokens: rows and the 16 × 768
# tokens the baseline model's ImageProjection gives
LEACE_FIT_ROWS = 32
# the kernels' shapes on the infer path that the 512², batch-8 path does not
# give them (run a: batch 13 at 512²; run b: 26 in the UNet with CFG, 13 in
# the VAE, at 256²); each kernel is held to its plain version at them,
# untimed, after the runs' launches are read
INFER_ATTN_SHAPES = [(13, 4096, 8, 40), (13, 1024, 8, 80), (13, 4096, 1, 512),
                     (26, 1024, 8, 40), (13, 1024, 1, 512)]
INFER_SPLIT3_SHAPES = [(13, 4096, 8, 40), (13, 1024, 8, 80), (13, 256, 8, 160)]
INFER_LN_SHAPES = [(13 * 4096, 320), (13 * 1024, 640), (26 * 1024, 320), (26 * 256, 640)]
INFER_GN_SHAPES = [(13, 4096, 320), (13, 1024, 640), (13, 256, 1280), (13, 64, 1280),
                   (26, 1024, 320), (26, 256, 640), (26, 64, 1280)]

# the train CLI phase: a seeded synthetic LIMUC-style tree (four class
# directories of RGB PNGs larger than the 224 center crop), then
# psd_tpu_torch.pipelines.train.main on configs/train_ip.yaml (256², batch
# 64, full width): two steps (one epoch, a checkpoint, one EMA-swapped
# validation: the val loss over one batch, a 4-level grid of 10 steps), a
# resume from "last" for a third step, and the infer CLI on its EMA
TRAIN_CLI_IMAGES = {"train": 128, "val": 32}
TRAIN_CLI_HW = (288, 352)
TRAIN_CLI_ARGS = ["training.update_starting_at_step=0", "training.log_every_n_steps=1",
                  "training.val_max_batches=1", "training.val_progression_levels=4",
                  "training.val_sampling_steps=10"]
TRAIN_CLI_GRID = 4
TRAIN_CLI_INFER = ["--image-size", "256", "--mes-steps", str(TRAIN_CLI_GRID),
                   "--sampling-steps", "10", "--seed", "0"]
# the kernels' shapes on this path that no earlier phase gives them: the
# encoder's (and the grid decoder's) mid-block attention, and the serving
# kernels in the val loss's batch-64 forward and the grid's batch-4 UNet on
# fp32 masters (held to their plain versions by their judges, not timed)
TRAIN_CLI_ATTN_SHAPES = [(64, 1024, 1, 512), (4, 1024, 1, 512)]
TRAIN_CLI_SPLIT3_SHAPES = [(64, 1024, 8, 40), (64, 256, 8, 80), (4, 1024, 8, 40),
                           (4, 256, 8, 80)]
TRAIN_CLI_LN_SHAPES = [(64 * 1024, 320), (64 * 256, 640), (64 * 64, 1280), (64 * 16, 1280),
                       (4 * 1024, 320), (4 * 256, 640)]
TRAIN_CLI_GN_SHAPES = [(64, 1024, 320), (64, 256, 640), (64, 64, 1280), (4, 1024, 320),
                       (4, 256, 640), (4, 64, 1280)]

# ln_gemm_kernel<Kind> in ln_gemm_sm90.cuh, by the enum's value (gn: gn_proj)
LN_KINDS = ("proj1", "proj3", "geglu", "gn")

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor
# cores and HBM3 bandwidth
PEAK_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# exp2 on the special function units: 16 a clock on each SM (Hopper); the
# attention's softmax takes one per logit, a floor beside its bound
SFU_PER_CLK_SM = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase 1 ---------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    log(smi)
    return smi


# ---- phase 2 ---------------------------------------------------------------
def phase_build():
    """Builds the kernels; returns ptxas's report of the attention forward
    kernels when this process ran nvcc, else None (the report in the cached
    build's log is an earlier run's and is only printed)."""
    from psd_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    built = kernels.build_seconds is not None
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if built else 0:.2f} s)")
    source = "" if built else "; from the cached build, an earlier run's"
    ptxas = ptxas_report(r"(narrow|wide)_attention_kernel")
    log("[build] ptxas, attention forward kernels (registers at entry, stack, spill "
        "stores/loads in bytes" + source + "): " + _ptxas_text(ptxas))
    if not any(k.startswith("narrow") for k in ptxas):
        raise SystemExit("chip_smoke.py: build.log names no narrow attention kernel")
    bwd = ptxas_report(r"(dq|dkv)_kernel")
    log("[build] ptxas, attention backward kernels (attention_bwd.cu; printed, not kept"
        + source + "): " + _ptxas_text(bwd))
    if not any(k.startswith("dkv") for k in bwd) or not any(k.startswith("dq") for k in bwd):
        raise SystemExit("chip_smoke.py: build.log names no dQ or dK/dV backward kernel")
    ln = ptxas_report(r"(ln_gemm_kernel|ln_stats_kernel)(?:ILN\w*?KindE(\d)E)?",
                      label=lambda m: m.group(1) if m.group(2) is None
                      else f"{m.group(1)}<{LN_KINDS[int(m.group(2))]}>")
    log("[build] ptxas, LayerNorm and GroupNorm GEMM kernels (ln_gemm_sm90.cuh; printed, "
        "not kept" + source + "): " + _ptxas_text(ln))
    if not any(k.startswith("ln_gemm_kernel") for k in ln) or "ln_gemm_kernel<gn>" not in ln:
        raise SystemExit("chip_smoke.py: build.log names no LayerNorm or gn_proj GEMM kernel")
    q8 = ptxas_report(r"(q8_kernel)ILi(\d+)ELb([01])E",
                      label=lambda m: f"q8_kernel<{m.group(2)}, "
                                      f"{'int8' if m.group(3) == '1' else 'qk8'}>")
    log("[build] ptxas, attention_q8 kernels (attention_q8.cu, by padded head dim and mode; "
        "printed, not kept" + source + "): " + _ptxas_text(q8))
    if len(q8) != 16:
        raise SystemExit(f"chip_smoke.py: build.log names {len(q8)} attention_q8 kernels, not 16")
    serialized = [line for line in (kernels.BUILD_ROOT / kernels.source_hash() / "build.log")
                  .read_text().splitlines() if "C7512" in line and "q8_kernel" in line]
    log(f"[build] ptxas serialized the wgmma of {len(serialized)} attention_q8 kernels "
        f"(C7512, insufficient registers; printed, not kept)")
    s3 = ptxas_report(r"(split3_kernel)")
    log("[build] ptxas, split3 kernels (split3.cu, by padded head dim; printed, not kept"
        + source + "): " + _ptxas_text(s3))
    if not any(k.startswith("split3_kernel") for k in s3):
        raise SystemExit("chip_smoke.py: build.log names no split3 kernel")
    return ptxas if built else None


def _ptxas_text(report: dict) -> str:
    return "; ".join(f"{k} {r['registers']} regs, stack {r['stack']}, spills "
                     f"{r['spill_stores']}/{r['spill_loads']}" for k, r in report.items())


def ptxas_report(kernel: str, label=None) -> dict:
    """Registers, stack frame and spills (bytes) that ptxas reported for each
    kernel whose name matches `kernel` (a regex with one group, the name;
    e.g. narrow<Dp>, wide) in this build's build.log (nvcc -Xptxas -v).
    `label(match)` names the entry where `kernel` has groups of its own."""
    from psd_tpu_torch.ops import kernels

    text = (kernels.BUILD_ROOT / kernels.source_hash() / "build.log").read_text()
    found, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?" + kernel
                      + ("" if label else r"(?:ILi(\d+)E)?"), line)
        if m:
            name = label(m) if label else m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            found[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[name]["registers"] = int(m.group(1))
            name = None
    return found


@functools.lru_cache(maxsize=None)
def sfu_exp2_per_s() -> float:
    """exp2 a second on the whole card: SFU_PER_CLK_SM on each SM at the
    card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return SFU_PER_CLK_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


# ---- phase 3 ---------------------------------------------------------------
def time_ms(fn, n: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(least ms, "bytes" | "operations") for work of `flops` bf16 FLOPs and
    `int8_ops` int8 operations moving `nbytes` bytes (each input read once,
    each output written once)."""
    t_ops = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(name, shape, fn_kernel, fn_plain, results, work, judge, fn_library=None,
             extra=None, note=None, key="shapes"):
    """`work` = (bf16 FLOPs, bytes[, int8 ops]) of the function at this
    shape; `extra` is added to the shape's entry; `note` (name → number) is
    printed beside the readings and not kept. `judge(out, ref)` → (ok, text,
    readings), on the whole outputs, decides; the max abs and relative
    errors are readings. The shape's entry goes to the kernel's `key` list;
    only "shapes" adds to the kernel's summed times and bound and its
    max_abs_err."""
    out_k = fn_kernel()
    out_p = fn_plain()
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    abs_err = rel_err = 0.0
    ok = True
    for a, b in zip(outs_k, outs_p):
        d = (a.float() - b.float()).abs().max().item()
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(b.float().abs().max().item(), 1e-12))
        ok = ok and bool(torch.isfinite(a).all())
    good, band, readings = judge(out_k, out_p)
    ok = ok and good
    extra = {**(extra or {}), **readings}
    del out_k, out_p, outs_k, outs_p
    ms_k = time_ms(fn_kernel)
    ms_p = time_ms(fn_plain)
    ms_l = time_ms(fn_library) if fn_library is not None else None
    b_ms, b_by = bound(*work)
    log(f"[kernel] {name:13s} {str(shape):28s} max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
        f"{band} {'ok' if ok else 'FAIL'}  "
        f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms  library "
        f"{'none' if ms_l is None else f'{ms_l:.4f} ms'}  bound {b_ms:.4f} ms ({b_by})"
        + "".join(f"  {k} {v:.4g}" for k, v in {**(note or {}), **(extra or {})}.items()))
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": None, "bound_ms": 0.0, "shapes": []})
    if key == "shapes":
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["ms"] += ms_k
        r["plain_ms"] += ms_p
        if ms_l is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + ms_l
        r["bound_ms"] += b_ms
    r.setdefault(key, []).append({
        "shape": list(shape), "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms_k,
        "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": b_ms, "bound_by": b_by,
        "flops": work[0], "bytes": work[1],
        **({"int8_ops": work[2]} if len(work) > 2 else {}), **(extra or {})})
    if not ok:
        raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")


def _bound_by(r) -> str:
    """The limit that gives the larger part of an entry's summed bound."""
    by = {"bytes": 0.0, "operations": 0.0}
    for sh in r["shapes"]:
        by[sh["bound_by"]] += sh["bound_ms"]
    return max(by, key=by.get)


def _sdpa(q, k, v):
    """torch's one-call attention on (B, S, H, D) operands (yardstick only)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)


def _check_lse(q, k, v, band: float) -> float:
    """An attention kernel's per-row log-sum-exp against lse_reference: max
    abs error in log2 units; raises beyond `band`."""
    from psd_tpu_torch.ops import attention

    _, lse = attention.attention_fwd(q, k, v, return_lse=True)
    d = (lse - attention.lse_reference(q, k, q.shape[-1] ** -0.5)).abs().max().item()
    ok = bool(torch.isfinite(lse).all()) and d <= band
    log(f"[kernel] attention lse  {str(tuple(q.shape)):28s} Sk {k.shape[1]}: max abs {d:.3e} "
        f"(log2 units, band {band:g}) {'ok' if ok else 'FAIL'} (not timed)")
    if not ok:
        raise SystemExit(f"chip_smoke.py: attention lse {tuple(q.shape)} disagrees with "
                         f"lse_reference")
    return d


def host_ms(fn, n: int = 20) -> float:
    """The host time of one call (its Python, checks, allocations and
    launch enqueue, before the device runs it): median of `n`, each after a
    synchronize."""
    times = []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times[3:])


def graph_ms(fn, calls: int = 10) -> float:
    """The device time of one call: `calls` calls captured in one CUDA
    graph, replayed (median of 10 replays over CUDA events) / calls; the
    host's time to prepare each launch is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay) / calls
    del graph
    return ms


def _check_ln_edge(randn, M, C, n_proj, n_geglu, mean_std):
    """ln_proj (3 and 1 outputs of n_proj columns) and ln_geglu (n_geglu
    columns) at an edge input against their plain versions with
    ln_gemm_judge; x gets a per-row offset of std `mean_std` (not timed)."""
    from psd_tpu_torch.ops import geglu
    from psd_tpu_torch.testing import ln_gemm_judge

    x = randn(M, C, dtype=torch.float32)
    x = (x + mean_std * randn(M, 1, dtype=torch.float32)).to(torch.bfloat16)
    lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
    lb = randn(C, std=0.1, dtype=torch.float32)
    cases = []
    for n_out in (3, 1):
        ws = tuple(randn(n_proj, C, std=C ** -0.5) for _ in range(n_out))
        cases.append((f"ln_proj n_out {n_out}", geglu.ln_proj_fwd(x, lw, lb, ws),
                      geglu.ln_proj_reference(x, lw, lb, ws)))
    w0 = randn(2 * n_geglu, C, std=C ** -0.5)
    b0 = randn(2 * n_geglu, std=0.02, dtype=torch.float32)
    cases.append(("ln_geglu", geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                  geglu.ln_geglu_reference(x, lw, lb, w0, b0)))
    for name, out, ref in cases:
        ok, text, _ = ln_gemm_judge(out, ref)
        label = (f"(M, C) {(M, C)}, N {n_geglu if name == 'ln_geglu' else n_proj}"
                 + (f", row means ~ N(0, {mean_std:g}²)" if mean_std else ""))
        log(f"[kernel] {name} edge {label}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} edge {label} disagrees with its plain version")


def _check_gn_edge(randn, B, S, C, N, mean_std):
    """gn_proj at an edge input against its plain version with
    gn_proj_judge, the affine folded from x's GroupNorm (32 groups) as the
    model folds it; x's channels get means of std `mean_std` (not timed)."""
    from psd_tpu_torch.ops import gnproj
    from psd_tpu_torch.ops.norms import group_norm_fold
    from psd_tpu_torch.testing import gn_proj_judge

    x = randn(B, S, C, dtype=torch.float32)
    x = (x + mean_std * randn(B, 1, C, dtype=torch.float32)).to(torch.bfloat16)
    gw, gb = group_norm_fold(x, 1.0 + randn(C, std=0.1, dtype=torch.float32),
                             randn(C, std=0.1, dtype=torch.float32), 32, 1e-6)
    w = randn(N, C, std=C ** -0.5)
    bias = randn(N, std=0.02, dtype=torch.float32)
    ok, text, _ = gn_proj_judge(gnproj.gn_proj_fwd(x, gw, gb, w, bias),
                                gnproj.gn_proj_reference(x, gw, gb, w, bias))
    label = (f"(B, S, C) {(B, S, C)}, N {N}" + (", half-full last row tile" if B * S % 128 else "")
             + (f", channel means ~ N(0, {mean_std:g}²)" if mean_std else ""))
    log(f"[kernel] gn_proj edge {label}: {text} {'ok' if ok else 'FAIL'} (not timed)")
    if not ok:
        raise SystemExit(f"chip_smoke.py: gn_proj edge {label} disagrees with its plain version")


def phase_kernels() -> dict:
    from psd_tpu_torch.ops import attention, geglu, gnproj, split3
    from psd_tpu_torch.testing import (ATTN_LSE_BAND, attention_judge, gn_proj_judge,
                                       ln_gemm_judge, split3_judge)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results: dict = {}
    for shape in ATTN_SHAPES + ATTN_LSE_SHAPES:
        B, S, H, D = shape
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        with_lse = shape in ATTN_LSE_SHAPES
        lse_abs = _check_lse(q, k, v, ATTN_LSE_BAND)
        # training's shape with its lse is a reading of its own, outside the
        # entry's sums, which cover the three serving shapes as in earlier runs
        _compare("attention", shape + (("lse",) if with_lse else ()),
                 lambda: attention.attention_fwd(q, k, v, return_lse=with_lse),
                 lambda: ((attention.attention_reference(q, k, v),
                           attention.lse_reference(q, k, D ** -0.5)) if with_lse
                          else attention.attention_reference(q, k, v)), results,
                 (4.0 * B * H * S * S * D, 4 * B * S * H * D * 2 + with_lse * B * H * S * 4),
                 fn_library=lambda: _sdpa(q, k, v), extra={"lse_max_abs": lse_abs},
                 judge=(lambda a, b: attention_judge(a[0], b[0])) if with_lse
                 else attention_judge,
                 note={"exp2_ms_at_sfu_rate": B * H * S * S / sfu_exp2_per_s() * 1e3},
                 key="lse_shapes" if with_lse else "shapes")
        del q, k, v
        torch.cuda.empty_cache()
    for (B, Sq, H, D), Sk in ATTN_NARROW_EDGE_SHAPES + ATTN_WIDE_EDGE_SHAPES:
        q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        ok, text, _ = attention_judge(attention.attention_fwd(q, k, v),
                                      attention.attention_reference(q, k, v))
        log(f"[kernel] attention edge {str((B, Sq, H, D)):22s} Sk {Sk}: {text} "
            f"{'ok' if ok else 'FAIL'} "
            f"({'narrow' if D <= attention.NARROW_MAX_D else 'wide'} path; not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: attention {(B, Sq, H, D)}, Sk {Sk} disagrees with "
                             f"its plain version")
        _check_lse(q, k, v, ATTN_LSE_BAND)
    for (B, S, H, D) in SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, 1.0, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2),
                 judge=split3_judge,
                 note={"device_ms": graph_ms(lambda: split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9)),
                       "wrapper_host_ms": host_ms(
                           lambda: split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9))})
    # the edge inputs draw from generators of their own, so the inputs of
    # the shapes after them stay those of earlier runs
    gs = torch.Generator(device=dev).manual_seed(11)
    for (B, S, H, D), lens, delta in SPLIT3_EDGE:
        q = torch.randn((B, S, H, D), generator=gs, device=dev).to(bf)
        banks = [torch.randn((B, n, H, D), generator=gs, device=dev).to(bf)
                 for n in lens for _ in range(2)]
        ok, text, _ = split3_judge(split3.split3_fwd(q, *banks, delta, 0.5, 0.5),
                                   split3.split3_reference(q, *banks, delta, 0.5, 0.5))
        log(f"[kernel] split3 edge {str((B, S, H, D)):20s} banks {lens} delta {delta:g} "
            f"(plan {split3.split3_plan(H, D, B * S, split3._sm_count(dev))}): {text} "
            f"{'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: split3 edge {(B, S, H, D)} banks {lens} disagrees "
                             f"with its plain version")
    for (M, C) in LN_SHAPES:
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        xhat = geglu.ln_reference(x, lw, lb)  # the cuBLAS yardstick's A
        for n_out in (3, 1):
            ws = tuple(randn(C, C, std=C ** -0.5) for _ in range(n_out))
            wcat = torch.cat(ws)
            _compare("ln_proj", (M, C, n_out),
                     lambda: geglu.ln_proj_fwd(x, lw, lb, ws),
                     lambda: geglu.ln_proj_reference(x, lw, lb, ws), results,
                     (2.0 * M * C * C * n_out,
                      M * C * 2 + 2 * C * 4 + n_out * (C * C * 2 + M * C * 2)),
                     judge=ln_gemm_judge,
                     note={"device_ms": graph_ms(lambda: geglu.ln_proj_fwd(x, lw, lb, ws)),
                           "cublas_product_ms": time_ms(lambda: torch.matmul(xhat, wcat.T)),
                           "wrapper_host_ms": host_ms(lambda: geglu.ln_proj_fwd(x, lw, lb, ws))})
        w0 = randn(8 * C, C, std=C ** -0.5)
        b0 = randn(8 * C, std=0.02, dtype=torch.float32)
        _compare("ln_geglu", (M, C),
                 lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                 lambda: geglu.ln_geglu_reference(x, lw, lb, w0, b0), results,
                 (2.0 * M * C * 8 * C,
                  M * C * 2 + 2 * C * 4 + 8 * C * C * 2 + 8 * C * 4 + M * 4 * C * 2),
                 judge=ln_gemm_judge,
                 note={"device_ms": graph_ms(lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0)),
                       "cublas_product_ms": time_ms(lambda: torch.matmul(xhat, w0.T)),
                       "wrapper_host_ms": host_ms(lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0))})
        del x, xhat, w0
        torch.cuda.empty_cache()
    # the edge inputs draw from a generator of their own, so the inputs of
    # the shapes after them stay those of earlier runs
    ge = torch.Generator(device=dev).manual_seed(9)
    ln_edges = [(M, C, C, 4 * C, LN_EDGE_MEAN_STD) for M, C in LN_SHAPES]
    ln_edges += [shape + (0.0,) for shape in LN_EDGE_SHAPES]
    for M, C, n_proj, n_geglu, mean_std in ln_edges:
        _check_ln_edge(lambda *shape, std=1.0, dtype=bf: (
            torch.randn(shape, generator=ge, device=dev) * std).to(dtype),
            M, C, n_proj, n_geglu, mean_std)
    for (B, S, C) in GN_SHAPES:
        x = randn(B, S, C)
        gw = 1.0 + randn(B, C, std=0.1, dtype=torch.float32)
        gb = randn(B, C, std=0.1, dtype=torch.float32)
        w = randn(C, C, std=C ** -0.5)
        bias = randn(C, std=0.02, dtype=torch.float32)
        _compare("gn_proj", (B, S, C),
                 lambda: gnproj.gn_proj_fwd(x, gw, gb, w, bias),
                 lambda: gnproj.gn_proj_reference(x, gw, gb, w, bias), results,
                 (2.0 * B * S * C * C,
                  B * S * C * 2 * 2 + 2 * B * C * 4 + C * C * 2 + C * 4),
                 judge=gn_proj_judge,
                 note={"device_ms": graph_ms(lambda: gnproj.gn_proj_fwd(x, gw, gb, w, bias)),
                       "wrapper_host_ms": host_ms(
                           lambda: gnproj.gn_proj_fwd(x, gw, gb, w, bias))})
    gg = torch.Generator(device=dev).manual_seed(12)
    gn_edges = [(B, S, C, C, GN_EDGE_MEAN_STD) for B, S, C in GN_SHAPES]
    gn_edges += [shape + (0.0,) for shape in GN_EDGE_SHAPES]
    gn_edges += [shape + (GN_EDGE_MEAN_STD,) for shape in GN_EDGE_SHAPES]
    for B, S, C, N, mean_std in gn_edges:
        _check_gn_edge(lambda *shape, std=1.0, dtype=bf: (
            torch.randn(shape, generator=gg, device=dev) * std).to(dtype), B, S, C, N, mean_std)
    return results


def q8_work(shape, mode):
    """(bf16 FLOPs, bytes, int8 ops) of the int8 attention at `shape`: QKᵀ
    in int8, P·V in bf16 ("qk8") or int8 ("int8"); its inputs as the kernel
    takes them (int8 q, k with fp32 row scales; bf16 v, or int8 v with fp32
    column scales) and its bf16 output."""
    B, S, H, D = shape
    prod = 2.0 * B * H * S * S * D
    nbytes = 2 * B * H * S * D + 2 * B * H * S * 4 + B * S * H * D * 2
    if mode == "int8":
        return 0.0, nbytes + B * H * S * D + B * H * D * 4, 2 * prod
    return prod, nbytes + B * S * H * D * 2, prod


def q8_tie_probe(dev):
    """Quantized operands at Q8_PROBE_SHAPE (int8 mode, scale 1) whose rows
    each have two live keys: the row max j0 (logit 0) and j1 with logit
    -(sq·c)·sk1, sq stepped ulp by ulp around each Q8_PROBE_TIES value of
    pn/ps ≈ 127·exp2(logit); every other key's logit is below -60000, so its
    p is 0. v is 1 on j1 and 0 elsewhere, so the output is pq(j1)·ps. The
    keys sit at other positions in each head. Returns (ops, shape, scale,
    number of rows whose pn/ps is exactly k + 1/2 with k even, computed as
    the plain version computes it)."""
    from psd_tpu_torch.ops import attention

    B, S, H, D = Q8_PROBE_SHAPE
    BH, Dp = B * H, attention._padded_dim(D)
    c = float(torch.tensor(attention.LOG2E, dtype=torch.float32))  # scale 1
    bh = torch.arange(BH, device=dev)
    j0 = (37 * bh + 11) % S
    j1 = (j0 + 1 + (53 * bh) % (S - 1)) % S
    qq = torch.zeros((BH, S, Dp), dtype=torch.int8, device=dev)
    qq[:, :, 0] = 1
    kq = torch.zeros((BH, S, Dp), dtype=torch.int8, device=dev)
    kq[:, :, 0] = -127
    kq[bh, j0, 0] = 0
    kq[bh, j1, 0] = -1
    sk = torch.full((BH, S), 1000.0, device=dev)
    sk1 = 1.0 + bh.float() / 64.0
    sk[bh, j0] = 1.0
    sk[bh, j1] = sk1
    ties = torch.tensor(Q8_PROBE_TIES, dtype=torch.float64, device=dev)
    r = torch.arange(S, device=dev)
    tie, step = ties[r % len(ties)], r // len(ties) - (S // len(ties)) // 2
    sq = (-torch.log2(tie / 127.0)[None, :] / (c * sk1.double()[:, None])).float()
    sq = (sq.view(torch.int32) + step[None, :].int()).view(torch.float32).contiguous()
    vq = torch.zeros((BH, Dp, S), dtype=torch.int8, device=dev)
    vq[bh, :D, attention.q8_key_position(j1)] = 127  # key j1, where the kernel takes it
    sv = torch.ones((BH, Dp), device=dev)
    sv[:, :D] = 1.0 / 127.0
    # pn/ps of key j1 as attention_q8_reference computes it
    x1 = (-1.0 * (sq * c)) * sk1[:, None]
    p1 = torch.exp2(x1)
    l_ = 1.0 + p1
    ratio = (p1 / l_) / ((1.0 / l_) * (1.0 / 127.0))
    n_ties = int(((ratio - torch.floor(ratio) == 0.5) & (torch.floor(ratio) % 2 == 0)).sum())
    return (qq, sq, kq, sk, vq, sv), Q8_PROBE_SHAPE, 1.0, n_ties


def phase_q8_kernels(results: dict) -> None:
    """attention_q8 in both modes against its plain version (exact integer
    products) on the quantized operands of seeded bf16 q, k, v, with the
    device time of one call (CUDA-graph replay), the wrapper's host time and
    the design's quarter-rate operations at the exp2 rate printed beside;
    for context only, the bf16 attention kernel at the same shape (no one
    PyTorch call computes int8 attention: library none). Then untimed edge
    shapes and the tie probe. Every shape and mode is checked before a
    failure is raised."""
    from psd_tpu_torch.ops import attention
    from psd_tpu_torch.testing import attention_q8_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    failed = []
    for shape in Q8_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = shape[-1] ** -0.5
        ms_bf16 = time_ms(lambda: attention.attention_fwd(q, k, v))
        B, S, H, _ = shape
        for mode in Q8_MODES:
            ops = attention.quantize_qkv(q, k, v, mode == "int8")
            run = functools.partial(attention.attention_q8, *ops, scale, shape)
            try:
                _compare("attention_q8", shape + (mode,), run,
                         lambda: attention.attention_q8_reference(*ops, scale, shape,
                                                                  torch.bfloat16),
                         results, q8_work(shape, mode), extra={"bf16_attention_ms": ms_bf16},
                         judge=attention_q8_judge,
                         note={"device_ms": graph_ms(run), "wrapper_host_ms": host_ms(run),
                               "quarter_rate_ms_at_exp2_rate": Q8_QUARTER_RATE_OPS[mode]
                               * B * H * S * S / sfu_exp2_per_s() * 1e3})
            except SystemExit as e:
                failed.append(str(e))
            del ops, run
        del q, k, v
        torch.cuda.empty_cache()

    # the edge shapes draw from a generator of their own, so the inputs of
    # the shapes above stay those of earlier runs
    ge = torch.Generator(device=dev).manual_seed(13)
    for shape in Q8_EDGE_SHAPES:
        q, k, v = (torch.randn(shape, generator=ge, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        for mode in Q8_MODES:
            ops = attention.quantize_qkv(q, k, v, mode == "int8")
            ok, text, _ = attention_q8_judge(
                attention.attention_q8(*ops, shape[-1] ** -0.5, shape),
                attention.attention_q8_reference(*ops, shape[-1] ** -0.5, shape, torch.bfloat16))
            log(f"[kernel] attention_q8 edge {str(shape):20s} {mode}: {text} "
                f"{'ok' if ok else 'FAIL'} (not timed)")
            if not ok:
                failed.append(f"chip_smoke.py: attention_q8 edge {shape} {mode} disagrees with "
                              f"its plain version")

    ops, shape, scale, n_ties = q8_tie_probe(dev)
    out = attention.attention_q8(*ops, scale, shape).float()
    ref = attention.attention_q8_reference(*ops, scale, shape, torch.bfloat16).float()
    bad = (out - ref).abs() > 2.0 ** -7 * ref.abs()
    ok = n_ties >= Q8_PROBE_MIN_TIES and bool(torch.isfinite(out).all()) and not bad.any()
    log(f"[kernel] attention_q8 tie probe {shape} int8: {n_ties} rows at pn/ps = k + 1/2 "
        f"(k even; at least {Q8_PROBE_MIN_TIES}), {int(bad.any(dim=-1).sum())} rows off "
        f"by more than 2^-7·|ref|, max abs {(out - ref).abs().max().item():.3e} "
        f"{'ok' if ok else 'FAIL'} (not timed)")
    if not ok:
        failed.append(f"chip_smoke.py: attention_q8 tie probe {shape}: {n_ties} ties, "
                      f"{int(bad.sum())} outputs off")
    del ops, out, ref
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit("\n".join(failed))


# ---- the op path -------------------------------------------------------------
def phase_op() -> dict:
    """psd_tpu_torch.ops.attention.spatial_attention(..., quant=) at the
    Q8_SHAPES, both modes, as scripts/bench_attn2.py drives psd_tpu's op
    (the quantization pre-pass, then the int8 kernel); launches counted
    from 0; outputs held against the plain version on the same pre-pass,
    with attention_q8's bands. Then the op's time, its kernel's alone on
    the op's operands and the pre-pass's (op minus kernel, and
    quantize_qkv timed alone), printed."""
    from psd_tpu_torch.ops import attention, kernels
    from psd_tpu_torch.testing import Q8_REL_L2_BAND, Q8_ROW_BAND, attention_q8_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    inputs = {shape: tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                           for _ in range(3)) for shape in Q8_SHAPES}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = {(shape, mode): attention.spatial_attention(*qkv, quant=mode)
            for shape, qkv in inputs.items() for mode in Q8_MODES}
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    worst, op_ms, prepass = 0.0, {}, {}
    for (shape, mode), out in outs.items():
        q, k, v = inputs[shape]
        ops = attention.quantize_qkv(q, k, v, mode == "int8")
        ref = attention.attention_q8_reference(*ops, shape[-1] ** -0.5, shape, torch.bfloat16)
        good, text, readings = attention_q8_judge(out, ref)
        if not (bool(torch.isfinite(out).all()) and good):
            raise SystemExit(f"chip_smoke.py: spatial_attention(quant={mode!r}) {shape} "
                             f"disagrees with the plain version: {text}")
        worst = max(worst, readings["rel_l2"])
        key = f"{shape} {mode}"
        op_ms[key] = time_ms(lambda: attention.spatial_attention(q, k, v, quant=mode), n=5)
        kernel = time_ms(lambda: attention.attention_q8(*ops, shape[-1] ** -0.5, shape), n=5)
        quant = time_ms(lambda: attention.quantize_qkv(q, k, v, mode == "int8"), n=5)
        prepass[key] = {"op_minus_kernel_ms": op_ms[key] - kernel, "quantize_qkv_ms": quant}
        del ops, ref
    log(f"[op] spatial_attention(quant=qk8|int8) at {Q8_SHAPES}: launches {counts}; "
        f"largest rel L2 vs plain {worst:.3e} (band {Q8_REL_L2_BAND:g}; each query row "
        f"within {Q8_ROW_BAND:.3g}); op ms (pre-pass + kernel) {op_ms}")
    log("[op] the pre-pass (quantize_qkv, plain torch) a call, ms: "
        + "; ".join(f"{k}: op - kernel {v['op_minus_kernel_ms']:.4f}, alone "
                    f"{v['quantize_qkv_ms']:.4f}" for k, v in prepass.items()))
    if counts["attention_q8"] != len(outs):
        raise SystemExit(f"chip_smoke.py: the op path launched attention_q8 "
                         f"{counts['attention_q8']} times, not {len(outs)}")
    del inputs, outs
    torch.cuda.empty_cache()
    return {"counts": counts, "op_ms": op_ms, "prepass": prepass}


# ---- phase 4 ---------------------------------------------------------------
def phase_unet() -> dict:
    from psd_tpu_torch.core.mode import KERNELS, disable_kernels
    from psd_tpu_torch.models.init import flax_init_
    from psd_tpu_torch.models.layers import store_weights_in_
    from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config
    from psd_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cfg = sd14_unet_config(attn_mode="split3", gate_init_anatomy=(0.1, 0.9),
                           gate_init_disease=(0.9, 0.1), dtype=torch.bfloat16)
    with dev:
        unet = UNet2DCondition(cfg).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    flax_init_(unet, g)
    store_weights_in_(unet, torch.bfloat16)  # as DADD stores them for serving
    x = torch.randn((8, 64, 64, 4), generator=g, device=dev)
    t = torch.full((8,), 501, dtype=torch.int32, device=dev)
    ctx = torch.randn((8, 48, 768), generator=g, device=dev)

    def run():
        return unet(x, t, ctx, 1.0)

    with torch.inference_mode():
        kernels.reset_launch_counts()
        out_k = run()
        torch.cuda.synchronize()
        counts = {k: kernels.launch_counts[k] for k in SERVE_KERNELS}
        with disable_kernels(*KERNELS):
            out_p = run()
        torch.cuda.synchronize()
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        ms_k = time_ms(run, n=3, warmup=1)
        with disable_kernels(*KERNELS):
            ms_p = time_ms(run, n=3, warmup=1)
        ab = _gn_proj_ab(run)
        device = {side: _eps_device_ms(run, off) for side, off in
                  (("kernels", ()), ("LN kernels off", ("ln_proj", "ln_geglu")),
                   ("all plain", KERNELS))}
    ok = bool(torch.isfinite(out_k).all()) and rel <= UNET_REL_BAND
    log(f"[unet] SD-scale split3 eps (8,64,64,4), 48 tokens, delta 1.0: "
        f"rel L2 kernels vs plain {rel:.3e} (band {UNET_REL_BAND:g}) "
        f"{'ok' if ok else 'FAIL'}; launches {counts}; "
        f"eps {ms_k:.2f} ms on kernels, {ms_p:.2f} ms plain")
    log(f"[unet] gn_proj on vs off, {GN_AB_PAIRS} alternating pairs (host clock, ms; "
        f"median [quartiles]): " + "; ".join(
            f"{side} wall {_q(ab[side]['wall'])} enqueue {_q(ab[side]['enqueue'])}"
            for side in ("on", "off"))
        + f"; paired wall difference on - off {_q(ab['diff'])}")
    log("[unet] eps device ms (one eps captured in a CUDA graph, replayed; the host's "
        "enqueue left out): " + ", ".join(f"{k} {v}" for k, v in device.items())
        + f"; host enqueue of an eps on the kernels {_q(ab['on']['enqueue'])} ms")
    if not ok or min(counts.values()) == 0:
        raise SystemExit("chip_smoke.py: UNet on the kernels disagrees with the plain "
                         "versions or skipped a kernel")
    del unet, out_k, out_p
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "eps_ms": ms_k, "eps_plain_ms": ms_p, "gn_proj_ab": ab,
            "device_ms": device}


def _eps_device_ms(run, off) -> str:
    """The device time of one eps with the kernels `off` routed to their
    plain versions (graph_ms of one call), or "not measured" and why when
    the eps cannot be captured in a CUDA graph."""
    from psd_tpu_torch.core.mode import disable_kernels

    try:
        with disable_kernels(*off):
            ms = f"{graph_ms(run, calls=1):.2f}"
    except RuntimeError as e:
        ms = f"not measured ({str(e).splitlines()[0][:100]})"
    torch.cuda.empty_cache()
    return ms


def _q(xs) -> str:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"{q2:.3f} [{q1:.3f}, {q3:.3f}]"


def _gn_proj_ab(run) -> dict:
    """Eps times with gn_proj on and off (its kill switch: the plain GroupNorm
    then feeds the plain proj_in, the serving path before gn_proj was ported),
    in alternating pairs; each side of a pair is the median of 3 eps. Wall is
    the host clock around a synchronized eps, enqueue the time until the
    forward returns (before the synchronize)."""
    from psd_tpu_torch.core.mode import disable_kernels

    def one():
        walls, enqueues = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            enqueues.append((t1 - t0) * 1e3)
        return statistics.median(walls), statistics.median(enqueues)

    ab = {side: {"wall": [], "enqueue": []} for side in ("on", "off")}
    for i in range(GN_AB_PAIRS):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            if side == "on":
                wall, enq = one()
            else:
                with disable_kernels("gn_proj"):
                    wall, enq = one()
            ab[side]["wall"].append(wall)
            ab[side]["enqueue"].append(enq)
    ab["diff"] = [a - b for a, b in zip(ab["on"]["wall"], ab["off"]["wall"])]
    return ab


# ---- phase 5 ---------------------------------------------------------------
class _ServeProbe:
    """Wraps a GenerationServer's `_dispatch` and `_fulfill` (instance
    attributes) to record their order and the host seconds of each dispatch
    (the enqueue, or the replay's copies and launch, of one batch)."""

    def __init__(self, server):
        self.events, self.dispatch_s = [], []
        dispatch, fulfill = server._dispatch, server._fulfill

        def timed_dispatch(batch):
            t0 = time.perf_counter()
            out = dispatch(batch)
            self.dispatch_s.append(time.perf_counter() - t0)
            self.events.append("dispatch")
            return out

        def logged_fulfill(*args):
            self.events.append("fulfill")
            return fulfill(*args)

        server._dispatch, server._fulfill = timed_dispatch, logged_fulfill


def _serve(server, requests):
    """Submit `requests` ((feats, target, source, seed) each) together and
    wait for every image → (images, host wall seconds)."""
    t0 = time.perf_counter()
    futures = [server.submit(*r) for r in requests]
    images = [f.result(timeout=900) for f in futures]
    return images, time.perf_counter() - t0


def _max_diff(a, b) -> float:
    import numpy as np

    return max(float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(a, b))


def _programs(model, kind: str):
    return [p for key, p in model.programs.items() if key[0] == kind]


def _replay_ms(prog, n: int = 3) -> dict:
    """One replay of a captured program: its device time (CUDA events,
    median of `n` after one) and the host time until `replay()` returns
    (the graph's launch, median of `n`)."""
    device = time_ms(prog.graph.replay, n=n, warmup=1)
    host = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"device_ms": device, "host_launch_ms": statistics.median(host)}


def _close(server, what: str) -> None:
    """Close a server and raise if its worker thread did not stop."""
    server.close()
    if server._worker.is_alive():
        raise SystemExit(f"chip_smoke.py: the {what} server worker did not stop")


def _graph_eager_ab(make_server, requests, pairs: int):
    """Served-batch wall times with graphs and eagerly (core.mode.eager()
    around the server's construction), in `pairs` alternating pairs; also
    each side's host dispatch seconds and each eager batch's peak memory."""
    from psd_tpu_torch.core.mode import eager

    servers = {"graphs": make_server()}
    with eager():
        servers["eager"] = make_server()
    probes = {side: _ServeProbe(s) for side, s in servers.items()}
    walls = {"graphs": [], "eager": []}
    peak = {"graphs": 0.0, "eager": 0.0}
    for i in range(pairs):
        for side in (("graphs", "eager") if i % 2 == 0 else ("eager", "graphs")):
            torch.cuda.reset_peak_memory_stats()
            _, wall = _serve(servers[side], requests)
            walls[side].append(wall)
            peak[side] = max(peak[side], torch.cuda.max_memory_allocated() / 2**30)
    for side, s in servers.items():
        _close(s, f"A/B {side}")
    return {"wall_s": walls, "dispatch_s": {k: p.dispatch_s for k, p in probes.items()},
            "peak_gib": peak}


def capture_failure_child() -> None:
    """Run by _check_capture_failure in a child process (a failed capture
    can leave state in torch's caching allocator, so the parent's memory
    stays clean). A capture that fails raises, and nothing runs eagerly in
    its place: the VAE's forward is wrapped with a host sync (`.item()`),
    which CUDA refuses under stream capture; generate at batch 8, 256², 2
    steps must raise, keep no program and call the VAE once (the eager
    warm-up; the capture's call is the one that raised). A second call of
    the same key raises again without calling the VAE (the failure is
    recorded, nothing is captured again). Unwrapped, with the record
    cleared, the same key then captures and replays. Beside it, whether a
    program's pool is given back (programs dropped, gc, empty_cache) before
    and after the failure. Prints one JSON line."""
    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD

    cfg = load_config(ROOT / "configs" / "train_ip.yaml")
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    feats = np.random.default_rng(1).standard_normal((8, 257, 1024)).astype(np.float32)
    cond = model.prepare_inference_cond(np.linspace(0, 3, 8), np.zeros(8), feats)
    x0 = torch.randn((8, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(9),
                     device="cuda")

    def run(steer):
        return model.generate(cond, x0=x0, image_size=256, sampling_steps=2, steer_scale=steer)

    def given_back():
        """GiB reserved with a program, then with it dropped."""
        held = torch.cuda.memory_reserved() / 2**30
        model.programs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return held, torch.cuda.memory_reserved() / 2**30

    run(0.0)
    before = given_back()
    vae, calls = model.vae, []
    real = vae.forward

    def syncing(z):
        calls.append(float(z.abs().amax().item()))  # a host sync
        return real(z)

    vae.forward = syncing

    def raises():
        try:
            run(1.0)
        except RuntimeError as e:
            return str(e).splitlines()[0][:160]
        return None

    try:
        raised = raises()
        again = raises()
    finally:
        del vae.forward
    kept = len(model.programs)
    recorded = len(model.failed_captures)
    model.failed_captures.clear()
    img = run(1.0)
    torch.cuda.synchronize()
    replayed = len(model.programs) == 1 and bool(torch.isfinite(img).all())
    after = given_back()
    print(json.dumps({"raised": raised, "raised_again": again, "recorded": recorded,
                      "kept": kept, "vae_calls": len(calls),
                      "replayed": replayed, "reserved_gib_before_failure": before,
                      "reserved_gib_after_failure": after}), flush=True)


def _check_capture_failure() -> dict:
    """capture_failure_child in a child process; raises if the failed
    capture did not raise, left a program or ran eagerly in its place."""
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke as c; "
                           "c.capture_failure_child()"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    try:
        r = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        raise SystemExit(f"chip_smoke.py: the capture-failure child failed (rc "
                         f"{proc.returncode}): {proc.stderr[-3000:]}")
    ok = (proc.returncode == 0 and r["raised"] is not None and r["kept"] == 0
          and r["vae_calls"] == 1 and r["recorded"] == 1
          and "failed to capture before" in (r["raised_again"] or "") and r["replayed"])
    log(f"[serve] a capture that fails (a host sync in the VAE's forward; child process): "
        f"raised {r['raised']!r}; programs kept {r['kept']}; the same key again raised "
        f"{r['raised_again']!r} without capturing; VAE calls {r['vae_calls']} (the first "
        f"call's eager warm-up); then, the record cleared, captured and replayed without the "
        f"sync: {r['replayed']}; GiB reserved with a program / after dropping it: before "
        f"the failure "
        f"{r['reserved_gib_before_failure']}, after it {r['reserved_gib_after_failure']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke.py: a failed capture did not raise, or left a program, "
                         "or ran eagerly in its place, or was captured again")
    return r


def phase_serve(card: str, unet: dict) -> dict:
    """The exact path (50 DDIM steps, bf16 VAE) at 512², batch 8, through
    GenerationServer: by graph replay (the default), against the eager run
    of the same requests, two batches in flight, fused=False, the A/B of
    graphs against eager, and a capture that fails."""
    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines.serve import GenerationServer

    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    size, steps, batch = cfg.dataset.image_size, cfg.diffusion.sampling_steps, 8
    t0 = time.perf_counter()
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] SD-scale DADD built and initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2 * batch, 257, 1024)).astype(np.float32)
    targets = np.tile(np.linspace(0.0, 3.0, batch), 2)
    # two batches, each led by its own seed
    requests = [(feats[i], targets[i], 1.0, i if i < batch else 100 + i) for i in range(2 * batch)]
    first = requests[:batch]

    def make_server(**kw):
        return GenerationServer(model, image_size=size, sampling_steps=steps, steer_scale=1.0,
                                max_batch=batch, max_wait_s=0.05, **kw)

    # the main path: one batch through the server, by graph replay
    server = make_server()
    probe = _ServeProbe(server)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    images, wall_first = _serve(server, first)
    counts = dict(kernels.launch_counts)
    serve_counts = {k: counts[k] for k in SERVE_KERNELS}
    dims = dict(kernels.attention_head_dims)
    peak_first = torch.cuda.max_memory_allocated() / 2**30
    (prog,) = _programs(model, "generate")
    launches = dict(prog.launches)  # its capture's launches: what each replay launches
    torch.cuda.empty_cache()
    mem_graph = {"allocated": torch.cuda.memory_allocated() / 2**30,
                 "reserved": torch.cuda.memory_reserved() / 2**30}

    # the same batch again: a replay, which runs no wrapper
    torch.cuda.reset_peak_memory_stats()
    again, wall_replay = _serve(server, first)
    replay_host = {k: kernels.launch_counts[k] - counts[k] for k in SERVE_KERNELS}
    peak_replay = torch.cuda.max_memory_allocated() / 2**30
    # two batches in flight (pipeline_depth=2)
    probe.events.clear()
    images16, _ = _serve(server, requests)
    pipelined = probe.events[:4] == ["dispatch", "dispatch", "fulfill", "fulfill"]
    _close(server, "graph")

    # the eager run of the same requests
    with eager():
        eserver = make_server()
    torch.cuda.reset_peak_memory_stats()
    eager16, _ = _serve(eserver, requests)
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    _close(eserver, "eager")

    # fused=False: two replays a batch, sample then decode_latents
    userver = make_server(fused=False)
    unfused, _ = _serve(userver, first)
    _close(userver, "fused=False")
    (sprog,), (dprog,) = _programs(model, "sample"), _programs(model, "decode")

    diffs = {"replay vs eager": _max_diff(images, eager16[:batch]),
             "pipelined vs eager": _max_diff(images16, eager16),
             "replay again": _max_diff(again, images),
             "fused=False vs fused=True": _max_diff(unfused, images)}
    expected = {k: SERVE_LAUNCHES[k] for k in SERVE_KERNELS}
    checks = {
        "shape (512,512,3)": all(im.shape == (size, size, 3) for im in images16),
        "finite": all(np.isfinite(im).all() for im in images16),
        "in [0,1]": all(im.min() >= 0.0 and im.max() <= 1.0 for im in images16),
        "targets differ": not np.allclose(images[0], images[-1], atol=1e-3),
        "all five serving kernels launched": min(serve_counts.values()) > 0,
        "attention saw D=40, 80 (UNet) and 512 (VAE)": all(dims.get(d, 0) > 0
                                                           for d in (40, 80, 512)),
        # first, again, two pipelined: four replays of one program; the
        # eager server replays nothing, fused=False one program of each kind
        "one replay a batch (fused=True)": prog.replays == 4,
        "two replays a batch (fused=False)": (sprog.replays, dprog.replays) == (1, 1),
        f"the capture launches {expected}": launches == expected,
        "host counts = warm-up + capture": serve_counts == {k: 2 * n for k, n in expected.items()},
        "a replay runs no wrapper": max(replay_host.values()) == 0,
        "two batches in flight": pipelined,
        "every image equals the eager run's": max(diffs.values()) == 0.0,
        "sample + decode launch what generate does":
            sprog.launches + dprog.launches == prog.launches,
    }

    ab = _graph_eager_ab(make_server, first, AB_PAIRS)
    replay_ms = {"generate": _replay_ms(prog), "sample": _replay_ms(sprog),
                 "decode": _replay_ms(dprog)}
    eps_ms, decode_ms = unet["device_ms"]["kernels"], replay_ms["decode"]["device_ms"]
    try:
        predicted = f"{steps} x {float(eps_ms):.2f} + {decode_ms:.2f} = " \
                    f"{steps * float(eps_ms) + decode_ms:.2f} ms"
    except ValueError:
        predicted = f"not measured (eps device ms {eps_ms})"

    log(f"[serve] {batch} requests, {size}px, {steps} DDIM steps, steer 1.0, max_batch "
        f"{batch}, by graph replay: first batch (warm-up {prog.warmup_s:.3f} s + capture "
        f"{prog.capture_s:.3f} s + instantiation {prog.instantiate_s:.3f} s + replay) wall "
        f"{wall_first:.3f} s; a replayed batch wall "
        f"{wall_replay:.3f} s, {batch / wall_replay:.4f} img/s on {card}")
    log(f"[serve] host launch counts over the first batch {counts} (the eager warm-up and the "
        f"capture); one replay launches {dict(prog.launches)}; attention by head dim {dims}")
    log(f"[serve] max abs difference {diffs}; fused=False: sample warm-up "
        f"{sprog.warmup_s:.3f} s + capture {sprog.capture_s:.3f} s + instantiation "
        f"{sprog.instantiate_s:.3f} s, decode {dprog.warmup_s:.3f} + {dprog.capture_s:.3f} + "
        f"{dprog.instantiate_s:.3f} s")
    log(f"[serve] A/B, {AB_PAIRS} alternating pairs, wall s median [quartiles]: graphs "
        f"{_q(ab['wall_s']['graphs'])}, eager {_q(ab['wall_s']['eager'])}; host dispatch s: "
        f"graphs {_q(ab['dispatch_s']['graphs'])}, eager {_q(ab['dispatch_s']['eager'])}; "
        f"walls {ab['wall_s']}")
    log("[serve] one replay, device ms (CUDA events) / host ms until replay() returns: "
        + ", ".join(f"{k} {v['device_ms']:.2f} / {v['host_launch_ms']:.2f}"
                    for k, v in replay_ms.items())
        + f"; {steps} x the eps's device time (phase 4) + decode: {predicted}")
    log(f"[serve] memory GiB: peak allocated over the first graph batch (warm-up + capture + "
        f"replay) {peak_first:.3f}, over a replayed batch {peak_replay:.3f}, over an eager "
        f"batch {peak_eager:.3f} (A/B: {ab['peak_gib']}); after capture, allocated "
        f"{mem_graph['allocated']:.3f}, reserved {mem_graph['reserved']:.3f} (weights and "
        f"the program's pool)")
    log(f"[serve] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: serve checks failed: {checks}")
    del server, eserver, userver, prog, sprog, dprog, probe, model
    gc.collect()  # the probes' wrappers hold their servers in cycles
    torch.cuda.empty_cache()
    failure = _check_capture_failure()
    return {"counts": counts, "head_dims": dims, "replay_launches": launches,
            "wall_s": wall_replay, "img_per_s": batch / wall_replay, "ab": ab,
            "replay_ms": replay_ms, "diffs": diffs, "failure": failure,
            "memory_gib": {"first_peak": peak_first, "replay_peak": peak_replay,
                           "eager_peak": peak_eager, **mem_graph}}


# ---- turbo -------------------------------------------------------------------
def _count_calls(obj, names):
    """Wrap obj.<name> for each name with a call counter (instance attrs)."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(obj, n)

        def counted(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        setattr(obj, n, counted)
    return calls


def phase_turbo(card: str, exact: dict) -> dict:
    """The turbo serving point (TURBO): DPM-Solver++(2M) at 25 steps,
    DeepCache stride 5, the int8 VAE decoder, at 512², batch 8: by graph
    replay against the eager run of the same requests, and the A/B."""
    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines.serve import GenerationServer

    if TURBO["tome_ratio"] != 0.0:
        raise SystemExit("chip_smoke.py: TURBO asks for ToMe, which the port does not have")
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    size, batch = cfg.dataset.image_size, 8
    t0 = time.perf_counter()
    model = DADD(cfg, vae_cfg=VAEConfig(quant=TURBO["vae_quant"]), dtype=torch.bfloat16,
                 device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[turbo] SD-scale DADD with the int8 VAE built in {time.perf_counter() - t0:.1f} s")
    calls = _count_calls(model.core, ("eps_deep", "eps_shallow"))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((batch, 257, 1024)).astype(np.float32)
    targets = np.linspace(0.0, 3.0, batch)
    requests = [(feats[i], targets[i], 1.0, i) for i in range(batch)]

    def make_server():
        return GenerationServer(model, image_size=size, sampling_steps=TURBO["steps"],
                                steer_scale=1.0, max_batch=batch, max_wait_s=0.05,
                                encoder_stride=TURBO["encoder_stride"],
                                cache_mode=TURBO["cache_mode"], sampler=TURBO["sampler"])

    server = make_server()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    images, wall_first = _serve(server, requests)
    counts = dict(kernels.launch_counts)
    dims = dict(kernels.attention_head_dims)
    peak_first = torch.cuda.max_memory_allocated() / 2**30
    calls_capture = dict(calls)
    (prog,) = _programs(model, "generate")
    launches = dict(prog.launches)  # its capture's launches: what each replay launches
    again, wall_replay = _serve(server, requests)
    calls_replay = {k: calls[k] - calls_capture[k] for k in calls}
    _close(server, "turbo graph")
    with eager():
        eserver = make_server()
    torch.cuda.reset_peak_memory_stats()
    eager_images, _ = _serve(eserver, requests)
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    _close(eserver, "turbo eager")
    calls_eager = {k: calls[k] - calls_capture[k] - calls_replay[k] for k in calls}
    diffs = {"replay vs eager": _max_diff(images, eager_images),
             "replay again": _max_diff(again, images)}
    expected = {k: TURBO_LAUNCHES[k] for k in SERVE_KERNELS}
    one = {"eps_deep": TURBO_FULL, "eps_shallow": TURBO_SHALLOW}
    checks = {
        "shape (512,512,3)": all(im.shape == (size, size, 3) for im in images),
        "finite": all(np.isfinite(im).all() for im in images),
        "in [0,1]": all(im.min() >= 0.0 and im.max() <= 1.0 for im in images),
        "targets differ": not np.allclose(images[0], images[-1], atol=1e-3),
        f"{TURBO_FULL} full and {TURBO_SHALLOW} shallow evaluations at warm-up and at "
        f"capture, none at replay, as many eagerly":
            calls_capture == {k: 2 * n for k, n in one.items()}
            and calls_replay == {k: 0 for k in one} and calls_eager == one,
        "all five serving kernels launched": min(counts[k] for k in SERVE_KERNELS) > 0,
        "attention saw D=40, 80 (UNet) and 512 (VAE)": all(dims.get(d, 0) > 0
                                                           for d in (40, 80, 512)),
        f"the capture launches {expected}": launches == expected,
        "one replay a batch": prog.replays == 2,
        "every image equals the eager run's": max(diffs.values()) == 0.0,
    }
    ab = _graph_eager_ab(make_server, requests, AB_PAIRS)
    replay_ms = _replay_ms(prog)
    log(f"[turbo] {batch} requests, {size}px, {TURBO}, by graph replay: first batch (warm-up "
        f"{prog.warmup_s:.3f} s + capture {prog.capture_s:.3f} s + instantiation "
        f"{prog.instantiate_s:.3f} s + replay) wall "
        f"{wall_first:.3f} s; a replayed batch wall {wall_replay:.3f} s, "
        f"{batch / wall_replay:.4f} img/s on {card}; the exact path's replayed batch in this "
        f"call: wall {exact['wall_s']:.3f} s, {exact['img_per_s']:.4f} img/s")
    log(f"[turbo] UNet evaluations: warm-up + capture {calls_capture}, replay {calls_replay}, "
        f"eager {calls_eager}; host launch counts over the first batch {counts}; one replay "
        f"launches {dict(prog.launches)}; attention by head dim {dims}")
    log(f"[turbo] max abs difference {diffs}; A/B, {AB_PAIRS} alternating pairs, wall s "
        f"median [quartiles]: graphs {_q(ab['wall_s']['graphs'])}, eager "
        f"{_q(ab['wall_s']['eager'])}; host dispatch s: graphs "
        f"{_q(ab['dispatch_s']['graphs'])}, eager {_q(ab['dispatch_s']['eager'])}; walls "
        f"{ab['wall_s']}")
    log(f"[turbo] one replay: device ms (CUDA events) {replay_ms['device_ms']:.2f}, host ms "
        f"until replay() returns {replay_ms['host_launch_ms']:.2f}; memory GiB: peak "
        f"allocated over the first graph batch {peak_first:.3f}, over an eager batch "
        f"{peak_eager:.3f}")
    log(f"[turbo] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: turbo checks failed: {checks}")
    del server, eserver, prog
    model.programs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    vae_ab = phase_vae_ab(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "head_dims": dims, "replay_launches": launches,
            "wall_s": wall_replay, "img_per_s": batch / wall_replay, "calls": calls_eager,
            "ab": ab, "replay_ms": replay_ms, "diffs": diffs, "vae_ab": vae_ab,
            "memory_gib": {"first_peak": peak_first, "eager_peak": peak_eager}}


def _spread_channel_gains_(vae, gen) -> bool:
    """Scale each output channel of the int8-gated decoder convs by a gain
    2^u, u ~ U(-VAE_GAIN_LOG2, VAE_GAIN_LOG2), and recompute their int8
    weights from the result. True when every int8 scale is per output
    channel.
    Flax-style init gives every output channel the same weight range, where
    a per-tensor weight scale costs nothing; spread channels are where the
    per-Cout scales matter (a per-tensor fault leaves the weakest channel
    2^-(2·VAE_GAIN_LOG2) of the int8 levels of the strongest)."""
    from psd_tpu_torch.models.layers import ResnetBlock2D, quantize_int8_weights_

    fp32 = {}
    with torch.no_grad():
        for prefix, m in vae.named_modules():
            if isinstance(m, ResnetBlock2D) and m.quant == "int8":
                for name in ("conv1", "conv2"):
                    w = getattr(m, name).weight
                    u = torch.rand(w.shape[0], generator=gen, device=w.device)
                    gain = torch.exp2((2.0 * u - 1.0) * VAE_GAIN_LOG2)
                    w.mul_(gain.to(w.dtype).reshape(-1, 1, 1, 1))
                    fp32[f"{prefix}.{name}.weight"] = w.float()
    quantize_int8_weights_(vae, fp32)
    # each output channel's scale is its own amax / 127
    return all(torch.equal(getattr(vae.get_submodule(k.rsplit(".", 2)[0]),
                                   k.rsplit(".", 2)[1] + "_sw"),
                           w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) * (1.0 / 127.0))
               for k, w in fp32.items())


def phase_vae_ab(model) -> dict:
    """int8 against bf16 VAE decode of the same seeded latents (8, 64, 64, 4)
    with the same weights (as scripts/check_int8_quality.py --vae does for
    psd_tpu): PSNR, max abs difference and decode ms of each, with the
    model's init weights and then with spread channel gains (the PSNR floor
    holds there); half-to-even rounding of exact ties on the card; and
    qconv3x3 against an exact fp64 conv of the same integer operands."""
    from psd_tpu_torch.models.layers import store_weights_in_
    from psd_tpu_torch.models.vae import VAEConfig, VAEDecode
    from psd_tpu_torch.ops.quant import qconv3x3, quant_cols, quant_rows

    dev = torch.device("cuda")
    with dev:
        bf = VAEDecode(VAEConfig(dtype=torch.bfloat16)).eval()
    store_weights_in_(bf.decoder, torch.bfloat16)
    z = torch.randn((8, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)

    def decode(vae):  # DADD.decode_latents with the given decoder
        return torch.clamp(vae(z / model.latent_scale).float() / 2.0 + 0.5, 0.0, 1.0)

    readings, per_cout = {}, None
    for weights in ("init", "spread"):
        if weights == "spread":
            per_cout = _spread_channel_gains_(model.vae,
                                              torch.Generator(device=dev).manual_seed(7))
        bf.load_state_dict(model.vae.state_dict())  # the same (bf16-stored) weights
        with torch.inference_mode():
            a, b = decode(model.vae).double(), decode(bf).double()
            mse = ((a - b) ** 2).mean().item()
            readings[weights] = {"psnr_db": 10.0 * math.log10(1.0 / max(mse, 1e-12)),
                                 "max_abs_diff": (a - b).abs().max().item()}
    with torch.inference_mode():
        ms = {"int8": time_ms(lambda: decode(model.vae), n=5),
              "bf16": time_ms(lambda: decode(bf), n=5)}

        # exact ties x/scale = n + 0.5 (the row's scale is exactly 1)
        ties = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]], device=dev)
        ties_ok = quant_rows(ties)[0][0, 1:].tolist() == [0, 2, 2, 0, -2, -2, 126]

        gq = torch.Generator(device=dev).manual_seed(4)
        x = torch.randn(QCONV_CHECK_SHAPE, generator=gq, device=dev).to(torch.bfloat16)
        C = QCONV_CHECK_SHAPE[-1]
        w = torch.randn((C, C, 3, 3), generator=gq, device=dev) * (9 * C) ** -0.5
        wq, sw = quant_cols(w, axis=0)
        got = qconv3x3(x, wq, sw.reshape(-1), out_dtype=torch.float32)
        sx = (x.float().abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-8)
              * (1.0 / 127.0))
        xq = torch.round(x.float() / sx).double()
        acc = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2), wq.double(),
                                         padding=1).permute(0, 2, 3, 1)
        want = acc * (sx.double() * sw.double().reshape(1, 1, 1, -1))
        qrel = ((got.double() - want).norm() / want.norm()).item()
    psnr = readings["spread"]["psnr_db"]
    ok = (math.isfinite(psnr) and psnr >= VAE_PSNR_FLOOR and per_cout and ties_ok
          and qrel <= QCONV_REL_BAND)
    log(f"[turbo] VAE decode int8 vs bf16, latents (8, 64, 64, 4), same weights: "
        + "; ".join(f"{k} weights PSNR {r['psnr_db']:.2f} dB, max abs diff "
                    f"{r['max_abs_diff']:.4f}" for k, r in readings.items())
        + f" (floor {VAE_PSNR_FLOOR:g} dB on spread); per-Cout scales {per_cout}; decode {ms['int8']:.2f} ms int8, "
        f"{ms['bf16']:.2f} ms bf16; ties half to even {ties_ok}; qconv3x3 "
        f"{QCONV_CHECK_SHAPE} vs exact fp64 conv: rel L2 {qrel:.3e} (band "
        f"{QCONV_REL_BAND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke.py: the int8 VAE decode fails its PSNR floor or its "
                         "per-Cout weight scales, rounds ties away from even, or qconv3x3 "
                         "disagrees with the exact conv")
    del bf
    return {"psnr_db": readings, "int8_ms": ms["int8"], "bf16_ms": ms["bf16"],
            "qconv_rel": qrel}


# ---- phase 6 ---------------------------------------------------------------
def _grad_compare(name, shape, tags, got, want):
    """Max abs error of each output against the bf16 band; raises if out."""
    errs = []
    for tag, a, b in zip(tags, got, want):
        d = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        ok = bool(torch.isfinite(a).all()) and d <= ATOL + RTOL * ref
        errs.append((tag, d, d / max(ref, 1e-12), ok))
    log(f"[train] {name} {shape} grads: " + "; ".join(
        f"{t} max_abs {d:.3e} max_rel {r:.3e} {'ok' if ok else 'FAIL'}" for t, d, r, ok in errs))
    if not all(e[3] for e in errs):
        raise SystemExit(f"chip_smoke.py: {name} {shape} gradients disagree with the plain version")
    return max(e[1] for e in errs)


def _check_attention_bwd(q, k, v, dout, label: str):
    """The backward kernel against autograd through the plain version with
    attention_bwd_judge; returns (max abs error, readings); raises beyond
    the bands."""
    from psd_tpu_torch.ops import attention
    from psd_tpu_torch.testing import attention_bwd_judge

    out, lse = attention.attention_fwd(q, k, v, return_lse=True)
    got = attention.attention_bwd(q, k, v, out, lse, dout)
    want = attention.attention_bwd_reference(q, k, v, dout)
    ok, text, readings = attention_bwd_judge(got, want)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    log(f"[train] attention_bwd {label}: {text}; max abs {err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke.py: attention_bwd {label} disagrees with its plain version")
    return err, readings


# ---- infer -------------------------------------------------------------------
def _clip_rel_l2(model, clip_img, feats) -> float:
    """The CLI's bf16 CLIP features against the same tower in fp32 (the
    same fp32 parameters, fp32 compute) on the same pixels: relative L2."""
    import dataclasses

    from psd_tpu_torch.models.clip import CLIPVisionTower

    with torch.device("cuda"):
        tower = CLIPVisionTower(dataclasses.replace(model.clip_cfg, dtype=torch.float32)).eval()
    tower.load_state_dict(model.clip.state_dict())
    x = torch.as_tensor(clip_img, device="cuda")
    with torch.inference_mode():
        ref = (tower.last_hidden_state(x) if model.core_cfg.use_image_projection_plus
               else tower.image_embeds(x))
    return ((feats[:1].float() - ref).norm() / ref.norm()).item()


def _infer_run(name: str, argv, out_dir: Path, card: str, structure: Path) -> dict:
    """One CLI run with the launch counts set to 0 just before it; checks
    its images, files and launches (those the routes give its batch)."""
    import numpy as np

    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines import infer
    from psd_tpu_torch.testing import route_launches

    argv = [str(ROOT / a) if a.startswith("configs/") else a for a in argv]
    argv += ["--structure-image", str(structure), "--output-dir", str(out_dir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = infer.main(argv)
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    dims = dict(kernels.attention_head_dims)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, images = out["model"], out["images"]
    size = images.shape[1]
    do_cfg = out["uncond"] is not None
    args = infer.build_argparser().parse_args(argv)
    expected = route_launches(model.core_cfg, model.vae_cfg, INFER_LEVELS, size,
                              args.sampling_steps or model.cfg.diffusion.sampling_steps,
                              cfg_pass=do_cfg)
    clip_img, _ = infer.load_structure_image(structure, size, model.clip_cfg.image_size)
    feats = model.encode_image_clip(clip_img)
    clip_rel = _clip_rel_l2(model, clip_img, feats)
    names = sorted(p.name for p in out_dir.iterdir())
    checks = {
        f"{INFER_LEVELS} images of ({size},{size},3)": images.shape == (INFER_LEVELS, size, size, 3),
        "finite": bool(np.isfinite(images).all()),
        "in [0,1]": bool(images.min() >= 0.0 and images.max() <= 1.0),
        "levels differ": not np.allclose(images[0], images[-1], atol=1e-3),
        "files written": names == sorted([Path(p).name for p in out["paths"]]
                                         + ["progression_grid.png", "structure_reference.png"]),
        f"launches {expected} (the routes at batch {INFER_LEVELS}"
        f"{', x2 in the UNet for CFG' if do_cfg else ''})":
            {k: counts[k] for k in expected} == expected,
        f"CLIP bf16 vs fp32 rel L2 <= {CLIP_REL_BAND:g}": clip_rel <= CLIP_REL_BAND,
    }
    log(f"[infer] run {name}: {' '.join(argv[:-4])}: phases (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["phases"].items())
        + f"; the CLI's time {out['seconds']:.3f} s ({INFER_LEVELS / out['seconds']:.4f} img/s), "
        f"main() wall with the model's build {wall:.3f} s; peak allocated "
        f"{peak:.3f} GiB; on {card}")
    log(f"[infer] run {name}: launches {({k: counts[k] for k in expected})}, attention by head "
        f"dim {dims}; CLIP ({'last_hidden_state' if feats.ndim == 3 else 'image_embeds'}) "
        f"bf16 vs fp32 rel L2 {clip_rel:.3e}")
    return {"out": out, "counts": counts, "head_dims": dims, "checks": checks,
            "clip_rel_l2": clip_rel, "wall_s": wall, "peak_gib": peak}


def _check_infer_shapes() -> None:
    """Each kernel of the infer path against its plain version at the
    INFER_* shapes, by its judge (not timed, not counted: the runs' counts
    are read before)."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    checks = []
    for shape in INFER_ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        checks.append(("attention", shape, attention_judge(
            attention.attention_fwd(q, k, v), attention.attention_reference(q, k, v))))
        del q, k, v
        torch.cuda.empty_cache()
    for (B, S, H, D) in INFER_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9),
            split3.split3_reference(q, *banks, 1.0, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[infer] {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C in INFER_LN_SHAPES:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in INFER_GN_SHAPES:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def _generate_device_time(model, cond) -> tuple:
    """Run (a)'s generate once more as the CLI runs it (eagerly, on its
    conditioning and initial latent) under torch.profiler's CUDA activity:
    the device's busy time (ms, the union of its activities' intervals),
    its activities (kernels, copies, fills) and the profiled wall (ms). The
    raw events are read, not torch's per-op tables, whose build takes a
    minute at this generate's 150k kernels."""
    from torch.profiler import ProfilerActivity, profile

    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.pipelines.infer import initial_draws

    steps = model.cfg.diffusion.sampling_steps
    x0, _ = initial_draws(model, INFER_LEVELS, 512, steps, 0.0, 0)
    torch.cuda.synchronize()
    with eager(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(cond, x0=x0, image_size=512, sampling_steps=steps, steer_scale=1.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation())
    busy_ns, end = 0, 0
    for start, stop in spans:
        busy_ns += max(0, stop - max(start, end))
        end = max(end, stop)
    return busy_ns / 1e6, len(spans), wall_ms


def phase_infer(card: str) -> dict:
    """The MES progression CLI (psd_tpu_torch.pipelines.infer.main) on the
    card: run (a) the README's command at 512² (routing gates, 13 levels,
    steer 1.0) and one batch-13 UNet eps on its conditioning, kernels
    against all plain; run (b) baseline mode at 256² with CFG 3.0, eta 0.5
    and a LEACE npz fitted here."""
    import numpy as np
    from PIL import Image

    from psd_tpu_torch.conditioning.leace import fit_leace, save_leace
    from psd_tpu_torch.core.mode import KERNELS, disable_kernels

    work = ROOT / "build" / "psd_tpu_torch" / "infer"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    structure = work / "structure.png"
    Image.fromarray(rng.integers(0, 256, (512, 512, 3), np.uint8)).save(structure)

    a = _infer_run("a", INFER_RUN_A, work / "a", card, structure)
    model, cond = a["out"]["model"], a["out"]["cond"]
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((INFER_LEVELS, 64, 64, 4), generator=g, device="cuda")
    t = torch.full((INFER_LEVELS,), 501, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        eps_k = model.core.eps(x, t, cond, 1.0)
        with disable_kernels(*KERNELS):
            eps_p = model.core.eps(x, t, cond, 1.0)
    eps_rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    a["checks"][f"batch-{INFER_LEVELS} eps kernels vs plain rel L2 <= {UNET_REL_BAND:g}"] = (
        bool(torch.isfinite(eps_k).all()) and eps_rel <= UNET_REL_BAND)
    log(f"[infer] run a: one UNet eps at batch {INFER_LEVELS} on the CLI's conditioning "
        f"{tuple(cond.shape)}, delta 1.0: rel L2 kernels vs plain {eps_rel:.3e}")
    del eps_k, eps_p
    dev_ms, n_launched, prof_ms = _generate_device_time(model, cond)
    gen_ms = a["out"]["phases"]["generate"] * 1e3
    a.update(generate_device_ms=dev_ms, generate_wall_ms=gen_ms, generate_activities=n_launched)
    log(f"[infer] run a: its generate again under torch.profiler (eager, as the CLI): device "
        f"busy {dev_ms:.3f} ms in {n_launched} device activities, profiled wall "
        f"{prof_ms:.3f} ms; the CLI's unprofiled generate phase {gen_ms:.3f} ms, so the device "
        + (f"idles {1.0 - dev_ms / gen_ms:.4f} of it" if dev_ms > 0 else
           "time is not measured (the profiler saw none)") + f"; on {card}")
    del model, cond
    a.pop("out")
    gc.collect()
    torch.cuda.empty_cache()

    # LEACE over the baseline model's projected image tokens (16 x 768)
    t0 = time.perf_counter()
    labels = np.arange(LEACE_FIT_ROWS) % 4
    tokens = (rng.standard_normal((LEACE_FIT_ROWS, 16, 768)) + 0.1 * labels[:, None, None])
    leace = fit_leace(tokens.astype(np.float32), labels)
    save_leace(leace, work / "leace.npz")
    fit_s = time.perf_counter() - t0
    b = _infer_run("b", INFER_RUN_B + ["--leace", str(work / "leace.npz")], work / "b", card,
                   structure)
    log(f"[infer] run b: LEACE fitted and saved in {fit_s:.3f} s (rows {LEACE_FIT_ROWS}, "
        f"stats {leace['stats']}); CFG batch in the UNet "
        f"{2 * INFER_LEVELS if b['out']['uncond'] is not None else INFER_LEVELS}")
    b.pop("out")
    gc.collect()
    torch.cuda.empty_cache()
    _check_infer_shapes()
    checks = {f"{run} {k}": v for run, r in (("a", a), ("b", b)) for k, v in r["checks"].items()}
    log(f"[infer] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: infer checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    head_dims = {d: a["head_dims"].get(d, 0) + b["head_dims"].get(d, 0)
                 for d in set(a["head_dims"]) | set(b["head_dims"])}
    return {"counts": counts, "head_dims": head_dims, "eps_rel_l2": eps_rel,
            "runs": {"a": a, "b": b}}


def phase_train_kernels(results: dict) -> None:
    """The attention backward kernel and split3's autograd.Function at the
    training shapes, against autograd through their plain versions; the
    backward also at its edge shapes."""
    from psd_tpu_torch.ops import attention, split3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape in ATTN_BWD_SHAPES:
        B, S, H, D = shape
        q, k, v, dout = (randn(*shape) for _ in range(4))
        err, readings = _check_attention_bwd(q, k, v, dout, str(shape))
        out, lse = attention.attention_fwd(q, k, v, return_lse=True)

        def fwd_bwd_kernel():
            o, l_ = attention.attention_fwd(q, k, v, return_lse=True)
            return attention.attention_bwd(q, k, v, o, l_, dout)

        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

        def fwd_bwd_sdpa():
            return torch.autograd.grad(_sdpa(qg, kg, vg), (qg, kg, vg), dout)

        o_sdpa = _sdpa(qg, kg, vg)  # a retained graph: SDPA's backward alone

        def bwd_sdpa():
            return torch.autograd.grad(o_sdpa, (qg, kg, vg), dout, retain_graph=True)

        ms_k = time_ms(lambda: attention.attention_bwd(q, k, v, out, lse, dout), n=5)
        ms_p = time_ms(lambda: attention.attention_bwd_reference(q, k, v, dout), n=3, warmup=1)
        ms_l = time_ms(bwd_sdpa, n=5)
        ms_fb = time_ms(fwd_bwd_kernel, n=5)
        ms_lfb = time_ms(fwd_bwd_sdpa, n=5)
        flops = 5 * 2.0 * B * H * S * S * D
        nbytes = 8 * B * S * H * D * 2 + B * H * S * 4
        b_ms, b_by = bound(flops, nbytes)
        # one exp2 a logit in each of the dQ and dK/dV passes
        exp2_ms = 2 * B * H * S * S / sfu_exp2_per_s() * 1e3
        log(f"[train] attention_bwd {shape}: kernel {ms_k:.4f} ms, plain (autograd through "
            f"the plain forward) {ms_p:.4f} ms, SDPA backward {ms_l:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), exp2 at the SFU "
            f"rate {exp2_ms:.4f} ms (printed, not kept); kernel fwd+bwd {ms_fb:.4f} ms, SDPA "
            f"fwd+bwd {ms_lfb:.4f} ms")
        r = results.setdefault("attention_bwd", {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                                 "library_ms": 0.0, "bound_ms": 0.0,
                                                 "fwd_bwd_ms": 0.0, "sdpa_fwd_bwd_ms": 0.0,
                                                 "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, val in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                         ("bound_ms", b_ms), ("fwd_bwd_ms", ms_fb), ("sdpa_fwd_bwd_ms", ms_lfb)):
            r[key] += val
        r["shapes"].append({"shape": list(shape), "max_abs_err": err, "ms": ms_k,
                            "plain_ms": ms_p, "library_ms": ms_l, "fwd_bwd_ms": ms_fb,
                            "sdpa_fwd_bwd_ms": ms_lfb, "bound_ms": b_ms, "bound_by": b_by,
                            "flops": flops, "bytes": nbytes, **readings})
        del q, k, v, dout, out, lse, qg, kg, vg, o_sdpa
        torch.cuda.empty_cache()

    # the narrow forward's edge shapes: every padded head dim the backward is
    # built for too, one or three heads, Sq != Sk (not timed)
    for (B, Sq, H, D), Sk in ATTN_NARROW_EDGE_SHAPES:
        q, dout = randn(B, Sq, H, D), randn(B, Sq, H, D)
        k, v = randn(B, Sk, H, D), randn(B, Sk, H, D)
        _check_attention_bwd(q, k, v, dout, f"edge {(B, Sq, H, D)} Sk {Sk} (not timed)")

    for (B, S, H, D) in SPLIT3_TRAIN_SHAPES:
        ins = [randn(B, S, H, D)] + [randn(B, 16, H, D) for _ in range(6)]
        dout = randn(B, S, H, D)

        def grads(fn):
            xs = [t.clone().requires_grad_(True) for t in ins]
            out = fn(*xs, 1.0, 0.1, 0.9, None)
            return (out.detach(),) + torch.autograd.grad(out, xs, dout)

        got = grads(split3.Split3Attention.apply)
        want = grads(split3.split3_reference)
        _grad_compare("split3 autograd.Function", (B, S, H, D),
                      ("out", "dq", "dk_anat", "dv_anat", "dk_dis", "dv_dis", "dk_delta",
                       "dv_delta"), got, want)
        ms_k = time_ms(lambda: grads(split3.Split3Attention.apply), n=5)
        ms_p = time_ms(lambda: grads(split3.split3_reference), n=5)
        log(f"[train] split3 fwd+bwd {(B, S, H, D)}: kernel forward + plain backward "
            f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")


def phase_train(card: str) -> dict:
    """3 SD-scale train steps, then kernels vs plain on one loss + backward."""
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import TRAINING_KERNELS, disable_kernels, training_mode
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.train import create_train_state, make_train_step

    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["training.update_starting_at_step=0"])
    size, B = cfg.dataset.image_size, TRAIN_BATCH
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0, for_training=True)
    state, tx = create_train_state(model)
    step = make_train_step(model, tx)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.core.parameters())
    log(f"[train] SD-scale DADD core for training ({n_params:,} fp32 parameters, remat "
        f"{model.core_cfg.unet.remat}) and its optimizer built in {time.perf_counter() - t0:.1f} s")
    assert all(p.dtype == torch.float32 for p in model.core.parameters())

    g = torch.Generator(device=dev).manual_seed(3)
    lat = size // 8
    batch = {"latents": torch.randn((B, lat, lat, 4), generator=g, device=dev),
             "labels": torch.randint(0, 4, (B,), generator=g, device=dev).float(),
             "clip_feats": torch.randn((B, 257, 1024), generator=g, device=dev)}
    watch = {n: p.detach().clone() for n, p in model.core.named_parameters()
             if n in ("unet.conv_in.weight", "unet.down_blocks_0_attentions_0.transformer_blocks_0"
                      ".attn1.to_q.weight", "image_projection.latents")}
    assert len(watch) == 3, sorted(watch)
    ema0 = {n: state.ema.params[n].clone() for n in watch}

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = dict(kernels.launch_counts)
    dims = dict(kernels.attention_head_dims)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    moved = {n: not torch.equal(w, dict(model.core.named_parameters())[n].detach())
             for n, w in watch.items()}
    ema_moved = {n: not torch.equal(ema0[n], state.ema.params[n]) for n in watch}
    tcfg = cfg.training
    ema_updates = sum(1 for i in range(TRAIN_STEPS) if i >= tcfg.update_starting_at_step and
                      (i - tcfg.update_starting_at_step) % tcfg.update_every_n_steps == 0)
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    checks = {
        "loss finite": all(map(math.isfinite, losses)),
        "grad norm finite": all(map(math.isfinite, norms)),
        "params changed": all(moved.values()),
        "EMA updated": all(ema_moved.values()) and state.ema.count == ema_updates,
        "attention, attention_bwd, split3 launched": min(
            counts["attention"], counts["attention_bwd"], counts["split3"]) > 0,
        f"attention_bwd launched {ATTN1_SITES} times a step":
            counts["attention_bwd"] == ATTN1_SITES * TRAIN_STEPS,
        "ln_proj, ln_geglu, gn_proj not launched": max(
            counts["ln_proj"], counts["ln_geglu"], counts["gn_proj"]) == 0,
        # at 256² only the 32×32 sites (S = 1024, D = 40) take the kernel
        "attention forward at D=40 only": set(dims) == {40},
    }
    log(f"[train] {TRAIN_STEPS} steps at {size}², batch {B}: losses {losses}, grad norms {norms}; "
        f"step times {[round(t, 4) for t in times]} s; steady step {step_s:.4f} s = "
        f"{B / step_s:.2f} img/s on {card}; peak memory {peak_gb:.2f} GiB")
    log(f"[train] launches over {TRAIN_STEPS} steps {counts}; attention by head dim {dims}")
    log(f"[train] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: train checks failed: {checks}")

    # kernels vs plain: one train_loss + backward with the same draws
    draws = model.sample_draws(tuple(batch["latents"].shape),
                               torch.Generator(device=dev).manual_seed(4))
    params = list(model.core.parameters())

    def loss_and_grad():
        for p in params:
            p.grad = None
        with training_mode():  # as the train step enters it
            loss, _ = model.train_loss(batch, draws=draws)
            loss.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                          for p in params])
        for p in params:
            p.grad = None
        return loss.detach(), flat

    leaves = [i for i, (n, _) in enumerate(model.core.named_parameters())
              if ATTN1_LEAF.fullmatch(n)]
    if len(leaves) != 3 * ATTN1_SITES:
        raise SystemExit(f"chip_smoke.py: expected {3 * ATTN1_SITES} attn1 q/k/v leaves, found "
                         f"{len(leaves)}")
    offsets = [0]
    for p in params:
        offsets.append(offsets[-1] + p.numel())

    def leaf_rel(gk, gp):
        rels = []
        for i in leaves:
            a, b = gk[offsets[i]:offsets[i + 1]], gp[offsets[i]:offsets[i + 1]]
            rels.append(((a - b).norm() / b.norm()).item())
        return max(rels)

    loss_k, grad_k = loss_and_grad()
    with disable_kernels(*TRAINING_KERNELS):
        loss_p, grad_p = loss_and_grad()
    rel_loss = abs(loss_k - loss_p).item() / abs(loss_p).item()
    rel_grad = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    rel_leaf = leaf_rel(grad_k, grad_p)
    ok = rel_loss <= TRAIN_LOSS_BAND and rel_grad <= TRAIN_GRAD_BAND and rel_leaf <= ATTN1_LEAF_BAND
    log(f"[train] one loss + backward, kernels vs plain, same draws: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (rel {rel_loss:.3e}, band {TRAIN_LOSS_BAND:g}); gradient rel L2 "
        f"{rel_grad:.3e} (band {TRAIN_GRAD_BAND:g}); attn1 q/k/v leaves at S=1024, largest rel "
        f"L2 {rel_leaf:.3e} (band {ATTN1_LEAF_BAND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke.py: the train step on the kernels disagrees with the plain "
                         "versions")
    del grad_k, grad_p

    # outside training mode the serving kernels have no backward: a loss
    # that wants gradients there is refused, not differentiated short
    try:
        model.train_loss(batch, draws=draws)
        refusal = ""
    except RuntimeError as e:
        refusal = str(e)
    refused = "training_mode" in refusal
    log(f"[train] train_loss with gradients outside training mode: "
        f"{'refused' if refused else 'NOT refused'} ({refusal or 'no error'})")
    if not refused:
        raise SystemExit("chip_smoke.py: train_loss outside training mode was differentiable "
                         "through a forward-only kernel")
    del model, state, step
    torch.cuda.empty_cache()
    return {"counts": counts, "head_dims": dims, "step_s": step_s, "img_per_s": B / step_s,
            "peak_gb": peak_gb,
            "rel_loss": rel_loss, "rel_grad": rel_grad, "rel_attn1_leaf": rel_leaf}


# ---- train CLI -----------------------------------------------------------------
def _write_tree(root: Path) -> None:
    """The seeded synthetic tree: smooth random RGB PNGs of TRAIN_CLI_HW,
    split evenly over four class directories."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    H, W = TRAIN_CLI_HW
    for split, n in TRAIN_CLI_IMAGES.items():
        for c in range(4):
            (root / split / f"Mayo_{c}").mkdir(parents=True)
            for i in range(n // 4):
                small = rng.integers(0, 256, (H // 16, W // 16, 3), dtype=np.uint8)
                img = Image.fromarray(small).resize((W, H), Image.BICUBIC)
                img.save(root / split / f"Mayo_{c}" / f"im{i:03d}.png")


def _differs_from_saved(state, directory: Path) -> list:
    """The parts of `state` (a host snapshot of it, as a save takes one) that
    differ from the step directory's files: [] when all are equal bit for bit."""
    from psd_tpu_torch.train import checkpoint

    snap = checkpoint.snapshot(state)
    bad = []

    def same(a, b, where):
        if isinstance(a, torch.Tensor):
            if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)):
                bad.append(where)
        elif isinstance(a, dict):
            if not isinstance(b, dict) or a.keys() != b.keys():
                bad.append(where)
            else:
                for k in a:
                    same(a[k], b[k], f"{where}/{k}")
        elif a != b:
            bad.append(where)

    for name, part in snap.items():
        path = directory / name
        saved = (json.loads(path.read_text()) if name.endswith(".json") else
                 torch.load(path, map_location="cpu", weights_only=True, mmap=True))
        same(part, saved, name)
    return bad


def _check_train_cli_shapes() -> None:
    """Each kernel of the train CLI path against its plain version by its
    judge at TRAIN_CLI_* (not timed, not counted: the runs' counts are read
    before)."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    checks = []
    for shape in TRAIN_CLI_ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        checks.append(("attention", shape, attention_judge(
            attention.attention_fwd(q, k, v), attention.attention_reference(q, k, v))))
        del q, k, v
    for (B, S, H, D) in TRAIN_CLI_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, 0.0, 0.1, 0.9),
            split3.split3_reference(q, *banks, 0.0, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[train_cli] {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C in TRAIN_CLI_LN_SHAPES:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in TRAIN_CLI_GN_SHAPES:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def _counted(fn, *args):
    """fn(*args) with the launch counts set to 0 just before it; → (its
    result, the counts, attention's counts by head dim, wall seconds)."""
    from psd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(kernels.launch_counts), dict(kernels.attention_head_dims), wall


def phase_train_cli(card: str, trained: dict) -> dict:
    """The training CLI on the card (psd_tpu_torch.pipelines.train.main,
    in-process) on a synthetic PNG tree at configs/train_ip.yaml's full
    width: two steps at 256², batch 64, with a checkpoint and an
    EMA-swapped validation; a resume from "last" for one more step, the
    restored state checked against the files bit for bit; the infer CLI on
    the checkpoint's EMA. Each run's launches against the routes' counts
    and phase 6's per step."""
    import shutil

    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.pipelines import infer, train
    from psd_tpu_torch.testing import route_launches

    work = ROOT / "build" / "psd_tpu_torch" / "train_cli"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    _write_tree(work / "data")
    tree_s = time.perf_counter() - t0
    free_gb = shutil.disk_usage(work).free / 1e9
    log(f"[train_cli] synthetic tree: {TRAIN_CLI_IMAGES} PNGs of {TRAIN_CLI_HW} in 4 classes "
        f"written in {tree_s:.2f} s; free disk at {work}: {free_gb:.1f} GB")
    cfg_path = ROOT / "configs" / "train_ip.yaml"
    cfg = load_config(cfg_path, TRAIN_CLI_ARGS)
    B, size = cfg.dataset.batch_size, cfg.dataset.image_size
    out_dir = work / "run"
    argv = ["--config", str(cfg_path), f"dataset.dataset_path={work / 'data'}", *TRAIN_CLI_ARGS,
            "--output-dir", str(out_dir)]
    per_step = {}
    for k, v in trained["counts"].items():
        if v % TRAIN_STEPS:
            raise SystemExit(f"chip_smoke.py: phase 6 launched {k} {v} times in {TRAIN_STEPS} "
                             "steps, not the same each step")
        per_step[k] = v // TRAIN_STEPS

    # run 1: two steps, the epoch's checkpoint and validation; watch three
    # parameters from the state's creation
    watched = {}
    make_state = train.create_train_state

    def watching(model, **kw):
        state, tx = make_state(model, **kw)
        named = dict(model.core.named_parameters())
        for n in ("unet.conv_in.weight", "image_projection.latents",
                  "unet.down_blocks_0_attentions_0.transformer_blocks_0.attn1.to_q.weight"):
            watched[n] = named[n].detach().clone()
        return state, tx

    torch.cuda.reset_peak_memory_stats()
    train.create_train_state = watching
    try:
        r1, counts1, dims1, wall1 = _counted(train.main, argv + ["--max-steps", "2"])
    finally:
        train.create_train_state = make_state
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    state, save1, laps1 = r1["state"], r1["checkpoints"].last_save, r1["laps"]
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    val = [r for r in records if "val/loss" in r]
    named = dict(state.model.core.named_parameters())
    moved = all(not torch.equal(w, named[n].detach()) for n, w in watched.items())
    tcfg = cfg.training

    def ema_gate(n):  # the EMA updates of n steps
        return sum(1 for i in range(n) if i >= tcfg.update_starting_at_step and
                   (i - tcfg.update_starting_at_step) % tcfg.update_every_n_steps == 0)

    ema1 = state.ema.count
    t0 = time.perf_counter()
    saved_diff = _differs_from_saved(state, out_dir / "checkpoints" / "2")
    cmp_s = time.perf_counter() - t0
    core_cfg, vae_cfg = state.model.core_cfg, state.model.vae_cfg
    del state, named, r1
    gc.collect()
    torch.cuda.empty_cache()

    # run 2: resume from "last" for a third step; the restored state is held
    # to the files just after the restore, before the step
    restored = {}
    restore = train.restore_into

    def checked(state, directory):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = restore(state, directory)
        torch.cuda.synchronize()
        restored.update(dir=directory, seconds=time.perf_counter() - t,
                        bytes=sum(p.stat().st_size for p in directory.iterdir()),
                        diff=_differs_from_saved(state, directory))
        return state

    # its phases each end with a synchronize, as under the CLI's --profile
    # (without its trace): run 1's are the host's alone
    timer = train.PhaseTimer
    train.restore_into = checked
    train.PhaseTimer = lambda device, sync: timer(device, sync=True)
    try:
        r2, counts2, dims2, wall2 = _counted(
            train.main, argv + ["training.resume_checkpoint=last", "--max-steps", "3"])
    finally:
        train.restore_into, train.PhaseTimer = restore, timer
    save2, laps2 = r2["checkpoints"].last_save, r2["laps"]
    step2, ema2 = r2["state"].step, r2["state"].ema.count
    del r2
    gc.collect()
    torch.cuda.empty_cache()
    ckpts = sorted(p.name for p in (out_dir / "checkpoints").iterdir())
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    steps_all = [r for r in records if "loss" in r]

    # run 3: the infer CLI on the checkpoint's EMA
    png = sorted((work / "data" / "val" / "Mayo_2").iterdir())[0]
    r3, counts3, dims3, wall3 = _counted(infer.main, [
        "--config", str(cfg_path), "--structure-image", str(png), "--checkpoint",
        str(out_dir / "checkpoints"), "--ema", "--output-dir", str(work / "infer"),
        *TRAIN_CLI_INFER])
    images = r3["images"]
    del r3
    gc.collect()
    torch.cuda.empty_cache()

    enc = {"attention": 1}  # the encoder's mid block, one launch a batch
    val_fwd = route_launches(core_cfg, vae_cfg, B, size, 1, decode=False)
    grid = route_launches(core_cfg, vae_cfg, TRAIN_CLI_GRID, size, tcfg.val_sampling_steps)

    def expect(**parts):
        return {k: sum(n * part.get(k, 0) for part, n in parts.values())
                for k in counts1}

    want1 = expect(steps=(per_step, 2), encodes=(enc, 3), val=(val_fwd, 1), grid=(grid, 1))
    want2 = expect(steps=(per_step, 1), encodes=(enc, 1))
    want3 = expect(grid=(grid, 1))
    checks = {
        "losses and grad norms finite": len(steps_all) == 3 and all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps_all),
        "params changed": moved,
        f"EMA count {ema_gate(2)} (its gate), validation on the EMA": ema1 == ema_gate(2)
            and len(val) == 1 and val[0]["val/ema_swapped"] is True,
        "val loss finite, grid on disk": len(val) == 1 and math.isfinite(val[0]["val/loss"])
            and Path(val[0]["val/progression_png"]).exists(),
        "saved state equal to the run's, bit for bit": saved_diff == [],
        "restored state equal to the files, bit for bit": restored.get("diff") == [],
        "resumed at step 2, ended at 3": restored.get("dir") == out_dir / "checkpoints" / "2"
            and step2 == 3 and [r["step"] for r in steps_all] == [1, 2, 3],
        "checkpoints 2 and 3 on disk": ckpts == ["2", "3"],
        f"EMA count after the resume {ema_gate(3)}": ema2 == ema_gate(3),
        "infer images finite in [0,1]": images.shape == (TRAIN_CLI_GRID, size, size, 3)
            and bool(np.isfinite(images).all()) and images.min() >= 0.0 and images.max() <= 1.0,
        f"run 1 launches {want1}": counts1 == want1,
        f"run 2 launches {want2}": counts2 == want2,
        f"run 3 launches {want3}": counts3 == want3,
        "D=512 launches: 3 encodes + 1 grid decode, 1 encode, 1 decode": (
            dims1.get(512), dims2.get(512), dims3.get(512)) == (4, 1, 1),
    }
    steady = steps[1]["img_per_sec"] if len(steps) > 1 else float("nan")

    def laps_text(laps):
        return "; ".join(f"{k} {[round(x, 4) for x in laps.get(k, [])]} s"
                         for k in ("data", "encode", "train_step", "checkpoint", "validation"))

    log(f"[train_cli] run 1 ({B} PNGs a batch at {size}², 2 steps): main() wall {wall1:.3f} s "
        f"with the model's build; phases as the CLI times them (no sync: host time), each "
        f"call: {laps_text(laps1)}; steady "
        f"{steady:.2f} img/s (the logged step 2) against phase 6's {trained['img_per_s']:.2f} "
        f"img/s; peak allocated {peak1:.2f} GiB; on {card}")
    log(f"[train_cli] run 2 (resume from \"last\", 1 step): main() wall {wall2:.3f} s; phases, "
        f"each ending with a synchronize (--profile's timing), each call: {laps_text(laps2)}")
    for name, (nbytes, secs) in (("step 2 (run 1)", save1), ("step 3 (run 2)", save2)):
        log(f"[train_cli] save of {name}: {nbytes / 1e9:.3f} GB written in {secs:.3f} s "
            f"({nbytes / 1e9 / secs:.3f} GB/s, the background write; the host snapshot is the "
            f"checkpoint phase above)")
    log(f"[train_cli] restore of step 2: {restored['bytes'] / 1e9:.3f} GB read in "
        f"{restored['seconds']:.3f} s ({restored['bytes'] / 1e9 / restored['seconds']:.3f} GB/s); "
        f"the saved state against the run's in {cmp_s:.3f} s; free disk with checkpoints "
        f"{ckpts} on disk: {shutil.disk_usage(work).free / 1e9:.1f} GB")
    log(f"[train_cli] run 3 (infer --checkpoint --ema, {TRAIN_CLI_GRID} levels, 10 steps): "
        f"main() wall {wall3:.3f} s")
    log(f"[train_cli] launches: run 1 {counts1}, by head dim {dims1}; run 2 {counts2}, by head "
        f"dim {dims2}; run 3 {counts3}, by head dim {dims3}")
    shutil.rmtree(work, ignore_errors=True)
    _check_train_cli_shapes()
    log(f"[train_cli] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: train CLI checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    counts = {k: counts1[k] + counts2[k] + counts3[k] for k in counts1}
    head_dims = {d: dims1.get(d, 0) + dims2.get(d, 0) + dims3.get(d, 0)
                 for d in set(dims1) | set(dims2) | set(dims3)}
    return {"counts": counts, "head_dims": head_dims, "img_per_s": steady,
            "saves": [save1, save2], "restore": (restored["bytes"], restored["seconds"])}


def main() -> int:
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("device", phase_device)
    ptxas = timed("build", phase_build)
    results = timed("kernels", phase_kernels)
    timed("q8 kernels", phase_q8_kernels, results)
    op = timed("op", phase_op)
    unet = timed("unet", phase_unet)
    served = timed("serve", phase_serve, card, unet)
    turbo = timed("turbo", phase_turbo, card, served)
    inferred = timed("infer", phase_infer, card)
    timed("train kernels", phase_train_kernels, results)
    trained = timed("train", phase_train, card)
    train_cli = timed("train cli", phase_train_cli, card, trained)
    log(f"[done] seconds per phase {seconds}, {sum(seconds.values()):.1f} s in all")

    entries = []
    for name, (replaces, source) in KERNELS.items():
        r = results[name]
        by_path = {path: run["counts"][name] for path, run in
                   (("serve", served), ("turbo", turbo), ("infer", inferred),
                    ("train", trained), ("train_cli", train_cli), ("op", op))}
        # serve and turbo count host launches (the eager warm-up and the
        # capture of their program); what each replay launches is apart
        by_replay = {path: run["replay_launches"].get(name, 0)
                     for path, run in (("serve", served), ("turbo", turbo))}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "launches_per_replay": by_replay,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": _bound_by(r),
                 "library_ms": r["library_ms"], "shapes": r["shapes"]}
        if "fwd_bwd_ms" in r:
            entry["fwd_bwd_ms"] = r["fwd_bwd_ms"]
            entry["sdpa_fwd_bwd_ms"] = r["sdpa_fwd_bwd_ms"]
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name == "attention":
            entry["sources"] = ATTN_SOURCES
            entry["lse_shapes"] = r["lse_shapes"]
            if ptxas is not None:
                entry["ptxas"] = ptxas
            entry["launches_by_head_dim"] = {
                path: run["head_dims"] for path, run in
                (("serve", served), ("turbo", turbo), ("infer", inferred),
                 ("train", trained), ("train_cli", train_cli))}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
