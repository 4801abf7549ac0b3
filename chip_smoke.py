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
               affine). split3 reads δ from device memory (a 0-d fp32
               tensor, as the model passes it): a replay probe captures one
               launch in a CUDA graph and replays it after each of
               SPLIT3_PROBE_DELTAS is written into its scalar, each replay
               bit-equal to a direct launch at that δ.
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
  4b. weights — published checkpoints into the port without JAX: files in
               the published formats at SD-v1.4 width drawn from a seed (the
               UNet as fp16 .safetensors, the VAE as fp32 .safetensors, CLIP
               ViT-L/14 as a torch .bin, torchvision-named resnet50, vgg16 and
               inception_v3), each converted by scripts/torch_port_weights.py
               in-process (unet, unet_split3, vae and clip through the
               meta-device gate), seconds and npz size printed; the converted
               UNet (plain) and VAE loaded through load_flax_ into bf16
               modules on the kernels: one eps (t 500, a 64² latent, 48
               tokens) and one decode against the diffusers-named mirror's
               fp32 forward on the CPU (tests/torch_ref) by relative L2
               within WEIGHTS_BANDS, a planted fault (one 3×3 conv's kernel
               with kh and kw swapped) beyond it, both printed; the held
               eps and decode launching attention (D = 40, 80, 512),
               ln_proj, ln_geglu and gn_proj; the same eps and decode with
               every kernel off, kernels against plain within WEIGHTS_BANDS
               (printed beside the mirror's readings); then the evaluation sweep
               (configs/train_ip.yaml at 256², 2 val images a class, 2 DDIM
               steps) with --inception-params / --vgg-params from the
               converted files: the weights it loaded equal to the npz key
               by key, finite metrics, its launches the routes'; then each
               kernel against its plain version at the held run's batch-1
               shapes (WEIGHTS_*, not timed). The files are removed at the
               end.
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
               against eager in AB_PAIRS (2) alternating pairs (wall, host
               dispatch, peak memory); each program's warm-up, capture and
               instantiation seconds; one replay's device time and host
               launch time against 50 × the eps's device time (phase 4) + the
               decode; and, in a child process, a capture that fails (a host
               sync in the VAE) raises, keeps no program and runs nothing
               eagerly in its place.
  5g. scalars — steer and guidance as device scalars, one captured
               program a sweep: (a) phase 5's model and its generate
               program (captured at steer 1.0) on 8 requests whose source
               and target labels differ, replayed at steer 0.0, 0.3 and 2.0
               with no new capture (DADD.programs and a capture counter
               unchanged), each replay bit-equal to an eager generate at
               that steer, the images at 0.3 and 2.0 apart by more than
               SCALARS_DIFF_FLOOR, and a planted fault (a replay that skips
               the steer copy, so it runs at the captured 1.0) caught; (b)
               baseline mode with CFG (configs/train.yaml at 256², batch 8,
               a UNet batch of 16, 10 DDIM steps): one capture replayed at
               guidance 1.5 and 3.0, each bit-equal to eager, the same fault
               on the guidance caught, its host launches (counts set to 0
               before the capture) twice route_launches' at a UNet batch of
               16 and a decode of 8, what a replay launches once that, and
               each kernel at (b)'s shapes held to its plain version by its
               judge (SCALARS_*; (a)'s are phase 3's). Prints each replay's
               wall and device time, each capture's seconds and peak
               memory, the card.
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
               a LEACE npz fitted in the phase by
               scripts/torch_compute_leace_projection.py (the baseline model
               in fp32 on a seeded tree of 32 PNGs in four classes; its four
               statistics and seconds printed). Each run: 13 finite images in
               [0, 1], the files written, each kernel's launches equal to
               what the routes give the batch (psd_tpu_torch.testing.
               route_launches: at batch 13 the LN kernels skip the 8²
               level), the CLIP tower's bf16 features against the same tower
               in fp32 (CLIP_REL_BAND); in (a) one batch-13 eps on the CLI's
               conditioning, kernels against all plain (UNET_REL_BAND). Then
               each kernel against its plain version by its judge at the
               path's batch-13 and batch-26 shapes (INFER_*; not timed).
               Printed: the CLI's phase times, its time and main()'s wall
               with the model's build, peak memory, the card.
  5e. unet_levers — the UNet's inference levers at full width (SD UNet,
               512², batch 8): each kernel at the shapes ToMe gives it
               (attention at S' = 2048, 3072, 1024 and at batch 13; split3
               at 2048; ln_proj and ln_geglu at B·S' = 16384 and 26624 rows)
               against its plain version by its judge, timed as phase 3
               times (kept under "levers_shapes", outside the sums); one
               eps per lever on phase 4's inputs — ToMe 0.5 in branch and in
               block mode, the int8 UNet — on the kernels against all plain
               (UNET_REL_BAND) with its launches equal to the routes', the
               int8 eps against the bf16 eps of the same weights
               (LEVER_INT8_BAND) and a planted fault (per-K scales at the
               square int8 projections) beyond it; the README's turbo point
               with ToMe (TOME_TURBO) served by graph replay, its images
               equal bit for bit to the eager run's, its program launching
               what route_launches gives, one replay's device and host ms
               printed beside phase 5b's; the infer CLI with the README's
               turbo flags at 512², 13 levels (finite images in [0, 1], the
               routes' launches, its seconds and peak memory).
  5d. serve_ranks — GenerationServer(mesh=) across ranks, started by
               torchrun (`chip_smoke.py --rank-worker`, each rank the server
               in-process) at phase 5's width (512², bf16, by graph replay)
               and SERVE_RANKS_STEPS DDIM steps (10; phase 5 serves the
               same requests at that depth for it; fused is off under a
               mesh: sample(mesh=) and
               decode_latents(mesh=), each rank its own programs at its rows,
               gathered): (a) two ranks on cuda:0 over gloo at dp 2,
               max_batch 8 (4 rows a rank): rank 0 answers phase 5's first 12
               requests (a full batch and a padded one), again, and with a
               planted fault (each rank's x0 drawn at its own 4 rows); (b)
               one rank on NCCL at dp 1, a world of one in this process (no
               torchrun: `_nccl_rank_here`). Checks: rank 0's images within
               SERVE_RANKS_BAND of phase 5's one-process server on the same
               requests and seeds (mean), the fault beyond it (both printed);
               equal bit for bit to one process at a rank's rows; the
               second round bit for bit, dp 1 equal to phase 5 bit for bit;
               each rank's two programs launching the routes' counts at its
               rows, the host counts warm-up + capture; then each serving
               kernel against its plain version at a rank's 4 rows
               (SERVE_RANK_*, not timed). Prints, per rank, each batch's wall
               (synchronized), the time in the gathers, one replay's device
               and host time, each program's warm-up / capture /
               instantiation, peak memory, the card.
  5f. serve_tp — tensor parallelism for serving, in 5d's gloo launch after
               its rounds: a (dp 1, tp 2) mesh over the same two ranks, the
               UNet's transformer sites cut to each rank's 4 heads and half
               the columns (DADD.shard_tp_). Before the cut, one process's
               eps and 4-step images (eagerly) of the server's first batch
               of 8. Checks: (a) each kernel at a rank's shapes (TP_*:
               attention and split3 at H = 4, ln_proj at C/2 columns,
               ln_geglu at 2C a half) against its plain version by its
               judge, timed as phase 3 times (kept under "tp_shapes"), tp
               4's shapes untimed; (b) the eps on the ranks within
               TP_EPS_BAND of one process's, two planted faults beyond it
               (rank 1 dropping net_2's all-reduce, rank 1 running rank 0's
               q heads), every rank's the same; (c) sample(mesh=) +
               decode_latents(mesh=) at 4 steps: every rank's images the
               same, within TP_IMAGE_BAND (mean) of one process's, the
               net_2 fault's beyond; (d) GenerationServer(mesh=) on the same
               8 requests, rank 0's images equal (c)'s; (e) each rank's
               launches those route_launches(tp=2) gives. Prints each rank's
               synced wall, its time in the all-reduces (each synced) and
               gathers, peak memory, the card.
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
               LR groups, the EMA from step 1 every 2 steps, an LR epoch of
               4 steps) takes 5 steps on a seeded random pre-encoded batch,
               eagerly (`make_train_step`) on one model and by replay
               (`compile_train_step`: a warm-up step and a capture, then
               4 replays of one program: a step with no EMA, the first
               copy, a blend and epoch 1's LR) on a second model of the
               same initial weights, each drawing from its state's
               generator; the replayed steps are held to the eager ones
               bit for bit (each step's metrics; after steps 4 and 5 every
               parameter, AdamW moment and step count, EMA tensor and
               count). Prints the program's warm-up, capture and
               instantiation seconds, its launch Counter against the
               eager per-step counts, the steady eager and replayed step
               and img/s, one step of each under torch.profiler (the
               device's busy time and idle share), the EMA's update
               alone (CUDA events), the program's graph pool and the peak
               memory. Loss and gradients on the
               kernels are held against the plain versions with the same
               draws, the flattened gradient and, on their own, the q/k/v
               weight gradients of the self-attention sites the kernel
               serves. Then accumulation: 2 micro-steps an optimizer step,
               batch 8, 4 steps on each model, the micro-step and the
               applying step two programs on one graph pool, bit for bit
               to eager (the kernels judged at batch 8's shapes first).
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
               the card. Its tree and checkpoint stay for phase 6c.
  6c. product_loop — psd_tpu's product loop (tests/test_product_loop.py) at
               full width on phase 6b's checkpoint and PNG tree, each CLI
               in-process: the augment factory (configs/train_ip.yaml at
               256², 12 images a UNet batch, 10 steps, the checkpoint's EMA)
               over 127 train PNGs, 381 images in 32 replays of one captured
               program (the last padded), with the split copies; the
               evaluation sweep (two scales, the val split, 4 images a
               class, random Inception and VGG; the two scales replay one
               captured program, dropped after the last); the classifier
               (configs/train_classifier.yaml: ResNet-18 at 224², batch 32)
               for 2 epochs on the synthetic-only split, judged on the 32
               real val PNGs. Checks: each generate's launches equal to
               route_launches at batch 12 (twice: warm-up and capture; none
               at replay; evaluate's two scales one program), the first
               replayed augment batch equal bit for
               bit to an eager generate of its inputs, the generated files'
               layout and counts against MESClassificationDataset's filter
               and balancing, finite metrics, the confusion matrix summing
               to the real val count; Inception, VGG and CLIP features in
               bf16 on the card against fp32 on the CPU of the same weights
               (BACKBONE_REL_BANDS), and planted faults above them; each
               kernel against its plain version at the path's batch-12
               shapes (LOOP_*, not timed). Prints augment's img/s,
               evaluate's generate and metrics phases, the checkpoint's
               freed pool, classify's step time, each peak memory. Deletes
               phase 6b's files.
  6d. train_ranks — the training CLI across ranks on a tree of its own
               at configs/train_ip.yaml's full width, 256², a global batch
               of 32 (16 a rank: two 14.7 GB states on one card), one loader
               thread, one step, each rank the CLI's main() in-process: the
               one-process run of the same argv (the reference, its initial
               parameters kept as the CLI built them, its post-step ones
               read from the state it returns; it writes no checkpoint:
               the CLI's checkpoint without a process group is 6b's); (b)
               one rank on NCCL at --dp 1, a world of one in this process
               (no torchrun: `_nccl_rank_here`), equal to the reference bit
               for bit in loss, grad norm and post-step parameters; (a) two
               ranks on cuda:0 over gloo at --dp 2 (DDP), then at --fsdp 2
               (FSDP2, its checkpoint the parameters alone), one launch of
               torchrun (`chip_smoke.py --rank-worker`, 6e between them),
               each against the reference. A run that fails prints each
               rank's last collective and a crashed rank's stack.
               Checks: each step's loss and grad norm (RANKS_LOSS_RTOL,
               RANKS_NORM_RTOL), the post-step parameters' difference over
               the reference's update (RANKS_UPDATE_BAND, set against
               every rank skipping the gradient average), each rank's
               launches equal to phase 6's per step × its steps + one
               encoder attention a batch, rank 0's checkpoint read by the
               infer CLI on its EMA; then each kernel against its plain
               version at a rank's 16 rows (RANKS_*, not timed). Prints each rank's
               synced step times, the share of the last step in gloo's
               collectives (torch.profiler's gloo spans, each from its call
               to its completion, DDP's own reducer's too; NCCL's complete
               at the enqueue, so not measured), its
               phases, peak memory and launches, the card.
  7. gates   — the port's turbo quality gates (scripts/torch_check_*.py)
               through their main() at configs' width (`Config()`): the
               stride gate (GATES_STRIDE: 20 synth-train steps by replay of
               compile_train_step's program, then the exact and
               converged-DPM baselines, deep5, tome0.5 and dpm5+deep5 at
               512², 10 steps), the distribution gate (GATES_DIST: 20
               synth steps, three exact sets, deep5 and int8 at 256², FID
               and CMMD on the random backbones) and the int8 gate (its
               defaults, then --vae at 512²); synth-train runs once, the
               distribution gate and the int8 gate's core taking its
               weights. Checks: every number finite, each variant apart
               from exact (the distribution gate's int8 set on the exact
               latents bit for bit, its images apart), the signal check
               above the noise floor, the synth-train losses finite, the
               exact program's latents equal to an eager run bit for bit,
               each variant's host launches, from 0, 2 × route_launches of
               its knobs, each kernel at the gates' shapes against its
               plain version (GATES_*). Prints the tables, each program's
               warm-up and capture seconds, the walls and the peak memory.
The line before the last is a JSON object with one entry per kernel:
`launches` counts the launches of the main-path runs (phases 3b, 4b, 5, 5b, 5c,
5d, 5e, 5f, 6, 6b, 6c, 6d and 7 (`gates`, its three gates' runs after its
judges), each with the counts set to 0 just before it, 4b
before its held eps and decode (`weights`) and before its CLI (`weights_cli`), 5c before each of
its two CLI runs, 5e before its served batch and its CLI run (`levers`), 6b
before each of its three, 6c before each of its three,
5d and 6d in each rank before its run, whose rank 0 of dp 2 over gloo is
`serve_dp` (5d, the host counts of its warm-ups and captures),
`serve_tp` (5f's rank 0: (c) and (d), each from 0) and `train_dp` (6d);
`launches_by_path` splits them; in phases 5, 5b and 5e the wrappers run, and count, at the eager warm-up
and at the capture of the batch's program, and `launches_per_replay` gives
what one replay launches),
`max_abs_err` is the largest over the kernel's shapes, `ms`, `plain_ms`,
`library_ms` and `bound_ms` sum one call at each of its main-path shapes
(attention_bwd's `library_ms` is SDPA's backward alone, on a retained
graph; `fwd_bwd_ms` and `sdpa_fwd_bwd_ms` are the two fwd+bwd readings);
`levers_shapes` (5e) and `tp_shapes` (5f) list the readings at those
phases' shapes, outside the sums. The last line is the device JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "psd_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: psd_tpu_torch/ is missing; run from a checkout of the repo")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from psd_tpu_torch.diffusion.sampler import key_step_count  # noqa: E402

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
# phase 3's probe of δ in device memory: the values written into a captured
# launch's scalar before each replay
SPLIT3_PROBE_DELTAS = (0.3, -1.5, 2.0)
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
TRAIN_STEPS, TRAIN_BATCH = 5, 64
# phase 6's gates: the EMA from step 1 every 2 (step 0 none, 1 the copy, 2
# none, 3 a blend, 4 none) and an LR epoch of 4 steps (step 4 takes epoch
# 1's LR), so that one captured program replays each case
TRAIN_ARGS = ["training.update_starting_at_step=1", "training.update_every_n_steps=2"]
TRAIN_STEPS_PER_EPOCH = 4
# the accumulation check: 2 micro-steps an optimizer step at batch 8
ACCUM_BATCH, ACCUM_STEPS = 8, 4
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
# tests/test_torch_turbo.py holds the two equal
TURBO = dict(tome_ratio=0.0, tome_mode="branch",
             encoder_stride=5, cache_mode="deep",
             sampler="dpm", steps=25, vae_quant="int8")
# DPM steps that are key steps (`sampler.key_step_count`) run the full UNet
TURBO_FULL = key_step_count(TURBO["steps"], TURBO["encoder_stride"])
TURBO_SHALLOW = TURBO["steps"] - TURBO_FULL
# what one served batch of 8 at 512² launches (PERF.md §6): the exact path
# (50 DDIM steps) and the turbo point; a captured program must launch these
SERVE_LAUNCHES = {"attention": 501, "split3": 750, "ln_proj": 1600, "ln_geglu": 800,
                  "gn_proj": 800}
TURBO_LAUNCHES = {"attention": 156, "split3": 185, "ln_proj": 382, "ln_geglu": 191,
                  "gn_proj": 191}
# served batches timed with and without graphs, in alternating pairs (the
# medians of longer runs stay in PERF.md §5)
AB_PAIRS = 2
# phase 5g: steer and guidance as device scalars. (a) Phase 5's program
# replayed at each steer; (b) a CFG program (configs/train.yaml, 256²) at
# each guidance, SCALARS_CFG_STEPS DDIM steps. The floor on the mean abs
# difference of (a)'s images at 0.3 and 2.0 (images in [0, 1], random
# weights) is a tenth of the first reading, 0.1585 on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6): a δ that reached no split3 site
# would read 0
SCALARS_STEERS = (0.0, 0.3, 2.0)
SCALARS_GUIDANCES = (1.5, 3.0)
SCALARS_CFG_STEPS = 10
SCALARS_DIFF_FLOOR = 1.5e-2
# (b)'s kernel shapes (route_launches' gates at a UNet batch of 16 on the
# 32² latent, the decode at batch 8), held to their plain versions by their
# judges, not timed: self-attention at the five 32² sites (the 16² and 8²
# levels and the cross-attention take the plain path), the LN kernels at
# every site, gn_proj where S % 64 == 0, the VAE's mid block
SCALARS_ATTN_SHAPES = [(16, 1024, 8, 40), (8, 1024, 1, 512)]
SCALARS_LN_SHAPES = [(16 * 1024, 320), (16 * 256, 640), (16 * 64, 1280), (16 * 16, 1280)]
SCALARS_GN_SHAPES = [(16, 1024, 320), (16, 256, 640), (16, 64, 1280)]
# phase 5e: the UNet's inference levers at full width (SD UNet, 512², batch
# 8). The README's turbo point: TURBO with ToMe at 0.5 in branch mode (the
# int8 VAE decoder; README.md "turbo serving")
TOME_TURBO = dict(TURBO, tome_ratio=0.5, tome_mode="branch")
# the kernels at the lengths ToMe merges the 64×64 sites' 4096 tokens to
# (2048 at ratio 0.5, 3072 at 0.25, 1024 at 0.75; batch 13: the CLI's), and
# the LayerNorm GEMMs at the merged rows (B·S' = 8·2048; 13·2048), C = 320
LEVER_ATTN_SHAPES = [(8, 2048, 8, 40), (8, 3072, 8, 40), (8, 1024, 8, 40), (13, 2048, 8, 40)]
LEVER_SPLIT3_SHAPES = [(8, 2048, 8, 40)]
LEVER_LN_PROJ_SHAPES = [(8 * 2048, 320, 3), (8 * 2048, 320, 1), (13 * 2048, 320, 3)]
LEVER_LN_GEGLU_SHAPES = [(8 * 2048, 320)]
# the int8 UNet's eps against the bf16 UNet's on the same weights, the int8
# attention sites' channels spread (the same function; relative L2). On an
# NVIDIA H100 80GB HBM3 (700 W) the sound int8 UNet reads 3.836e-2 and a
# planted fault, the square projections' weights quantized with per-K (input
# channel) scales where per-N ones belong, 0.8778 (PERF.md §6 PR 17); the
# band sits between. Without the spread the fault read 3.018e-2 against the
# sound 2.769e-2: flax-style init gives every channel the same range
LEVER_INT8_BAND = 0.1
# phase 5d: serving across ranks, GenerationServer(mesh=) started by
# torchrun at phase 5's width (512², bf16, by graph replay).
# The run has one card and NCCL refuses two ranks on one device, so (a) two
# ranks share cuda:0 over gloo at dp 2, max_batch 8 (4 rows a rank), and (b)
# one rank runs on NCCL at dp 1. Rank 0 answers phase 5's first 12 requests
# (a full batch and one of 4 padded to 8), once more (replays) and once with
# a planted fault: each rank drawing its x0 at its own 4 rows instead of
# taking its rows of the batch's draw of 8.
SERVE_RANKS_BATCH, SERVE_RANKS_REQUESTS = 8, 12
# 5d's depth: the ranks sample SERVE_RANKS_STEPS DDIM steps, and phase 5
# serves the same 12 requests at that depth in one process for them (the
# server's path and programs are those of 50 steps, each capture a fifth as
# long)
SERVE_RANKS_STEPS = 10
# rank 0's images against phase 5's one-process server on the same requests
# and seeds, the mean absolute difference on [0, 1]. The ranks run 4 rows
# where the one process runs 8, and cuDNN's and cuBLAS's bf16 sums at 4 rows
# round otherwise: one eps differs by 1.3e-2 relative L2 (all plain too),
# and the random-weight sampler grows it over the steps (PERF.md §6).
# On an NVIDIA H100 80GB HBM3 (700 W), at 10 steps the sound ranks read
# 1.660e-2 and the planted fault 0.1011 (PERF.md §6; at 50
# steps 0.1209 and 0.1633, with a band of 0.14), both deterministic; the
# band sits between. The exact check is beside it: the ranks' images equal,
# bit for bit, what one process gives at a rank's rows of the same batches
# and draws.
SERVE_RANKS_BAND = 0.05
# a rank's 4 rows: the serving kernels at phase 5's shapes at batch 4, held
# to their plain versions untimed (split3 at S = 64 too, which the route
# leaves to the plain path at any batch)
SERVE_RANK_ATTN_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 4096, 1, 512)]
SERVE_RANK_SPLIT3_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160),
                            (4, 64, 8, 160)]
SERVE_RANK_LN_SHAPES = [(4 * 4096, 320), (4 * 1024, 640), (4 * 256, 1280), (4 * 64, 1280)]
SERVE_RANK_GN_SHAPES = [(4, 4096, 320), (4, 1024, 640), (4, 256, 1280), (4, 64, 1280)]
# phase 5f: serving under tp, in 5d's torchrun launch: its two ranks on
# cuda:0 over gloo, after 5d's checks, on a second mesh (dp 1, tp 2) over
# them. Each rank holds half the heads and columns of every UNet
# transformer site (parallel/mesh.py::shard_tp_) and the whole batch of 8.
TP, TP_BATCH, TP_STEPS = 2, 8, 4
# the kernels at a rank's shapes (512², batch 8, tp 2): H/tp = 4 heads
# (attention at 64² and 32², split3 at 64², 32², 16²), ln_proj's C/tp
# columns and ln_geglu's 4C/tp a half at each level's rows; timed as phase 3
# times, kept under "tp_shapes" outside the entries' sums
TP_ATTN_SHAPES = [(8, 4096, 4, 40), (8, 1024, 4, 80)]
TP_SPLIT3_SHAPES = [(8, 4096, 4, 40), (8, 1024, 4, 80), (8, 256, 4, 160)]
TP_LN_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]
# untimed: tp 4's (2 heads; ln_proj N = C/4, ln_geglu N = C a half)
TP4_ATTN_EDGE = [(8, 4096, 2, 40)]
TP4_SPLIT3_EDGE = [(8, 4096, 2, 40), (8, 256, 2, 160)]
TP4_LN_EDGE = [(32768, 320, 80, 320), (8192, 640, 160, 640)]
# (b): one eps (latents (8, 64, 64, 4), t = 501, δ = 1, the batch's
# conditioning) of the tp ranks against the one-process eps of the same
# weights, relative L2 on rank 0. The ranks sum each row-parallel product
# of two halves of K in bf16 where one process sums all K in one cuBLAS
# product. On an NVIDIA H100 80GB HBM3 (700 W) the sound ranks read
# 1.628e-2 and the planted faults, rank 1 keeping its own half of net_2's
# product (the all-reduce's result dropped) 0.2382, rank 1 running rank 0's
# q heads 0.2036 (PERF.md §6, the tp serving entry); the band sits between.
# (f) holds the int8 UNet's eps on the ranks to it too: 3.224e-2 there (the
# bf16 sums' other order, and the int8 codes it flips; PERF.md §6, the
# int8 and tp train entry),
# where its sites' bit-equality guards the row-parallel scales.
TP_EPS_BAND = 5e-2
# (c), (d): TP_STEPS DDIM steps and the decode on the ranks against the one
# process, mean absolute difference of the images on [0, 1]: the sound
# ranks read 6.279e-3 there; the net_2 fault's images are read beside
TP_IMAGE_BAND = 2e-2
# (f): the int8 UNet under tp on 5f's mesh, phase 5e's int8 UNet (its
# weights, attention channels spread, and inputs): one eps on the ranks
# against the one-process int8 eps within TP_EPS_BAND, every rank's the
# same; and a row-parallel int8 site of each kind on the ranks, handed its
# rank's columns of one input, bit-equal to the whole site's output
# (torch._int_mm's int32 sums and the MAX of the row amax are exact), where
# the planted fault (each rank's scale from its own columns) is not:
# site → (module path, site name, rows)
TP_INT8_SITES = {"net_2 at C = 320": ("down_blocks_0_attentions_0.transformer_blocks_0.ff",
                                      "net_2", 8 * 4096),
                 "to_out_0 at C = 640": ("down_blocks_1_attentions_0.transformer_blocks_0.attn1",
                                         "to_out_0", 8 * 1024)}
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

# phase 4b: published checkpoints into the port without JAX. Files in the
# published formats and the manifests' full shapes, drawn from a seed
# (weights N(0, 1/fan_in), biases 0, norms 1): the SD-v1.4 UNet as fp16
# .safetensors, its VAE as fp32 .safetensors, CLIP ViT-L/14 as a torch .bin,
# torchvision-named resnet50 / vgg16 / inception_v3 (the mirrors' keys,
# tests/torch_ref/backbones.py) as .pth; each converted by
# scripts/torch_port_weights.py in-process (the gated kinds through the
# meta-device gate).
WEIGHTS_KINDS = [("unet", "unet.safetensors"), ("unet_split3", "unet.safetensors"),
                 ("vae", "vae.safetensors"), ("clip", "clip.bin"),
                 ("resnet50", "resnet50.pth"), ("vgg16", "vgg16.pth"),
                 ("inception", "inception.pth")]
# the converted UNet (plain) and VAE in bf16 on the kernels against the
# diffusers-named mirror's fp32 forward on the CPU over the same state dict:
# one eps at t = 500 on a (1, L, L, 4) latent with 48 context tokens, and the
# decode of a (1, L, L, 4) latent, L the served 64. Relative L2, each band
# between the sound reading and a planted fault's: one 3×3 conv's kernel
# with kh and kw swapped, the layout slip a converter makes (WEIGHTS_FAULTS,
# the port's parameter names).
WEIGHTS_LATENT = 64
WEIGHTS_BANDS = {"unet": 5e-2, "vae": 5e-2}
WEIGHTS_FAULTS = {"unet": "down_blocks_1_resnets_0.conv1",
                  "vae": "decoder.up_blocks_1_resnets_0.conv1"}
# the held eps and decode run once more with every kernel off, kernels
# against plain within the same bands; and the kernels' shapes on this path
# (batch 1 on the 64² latent: the plain UNet's self-attention at 64² and
# 32², the LN kernels at the sites whose rows the route admits, gn_proj at
# all 16 sites, the VAE's mid block) held to their plain versions by their
# judges, not timed
WEIGHTS_ATTN_SHAPES = [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 4096, 1, 512)]
WEIGHTS_LN_SHAPES = [(4096, 320), (1024, 640), (256, 1280)]
WEIGHTS_GN_SHAPES = [(1, 4096, 320), (1, 1024, 640), (1, 256, 1280), (1, 64, 1280)]
# then one port CLI reads converted files through its normal flags: the
# evaluation sweep with --inception-params / --vgg-params (the least costly:
# 2 val images a class, 24 jobs in two batches of 12 at 256², 2 DDIM steps,
# one scale, one eval seed)
WEIGHTS_EVAL_IMAGES = {"val": 8}
WEIGHTS_EVALUATE = ["--split", "val", "--scales", "1.0", "--batch-images", "4",
                    "--sampling-steps", "2", "--max-per-class", "2", "--num-eval-seeds", "1",
                    "--seed", "0"]

# the infer phase: the MES progression CLI as the README runs it (13 levels,
# steer 1.0) at the served resolution, then baseline mode with CFG, eta and
# LEACE at configs/train.yaml's 256²
INFER_LEVELS = 13
INFER_RUN_A = ["--config", "configs/train_ip.yaml", "--image-size", "512", "--mes-steps",
               str(INFER_LEVELS), "--steer-scale", "1.0", "--seed", "0"]
INFER_RUN_B = ["--config", "configs/train.yaml", "--mes-steps", str(INFER_LEVELS),
               "--guidance-scale", "3.0", "--eta", "0.5", "--seed", "0"]
# phase 5e: the infer CLI with the README's turbo flags at 512², 13 levels
INFER_TURBO = INFER_RUN_A + ["--sampler", "dpm", "--sampling-steps", str(TOME_TURBO["steps"]),
                             "--encoder-stride", str(TOME_TURBO["encoder_stride"]),
                             "--cache-mode", TOME_TURBO["cache_mode"],
                             "--tome-ratio", str(TOME_TURBO["tome_ratio"]),
                             "--tome-mode", TOME_TURBO["tome_mode"],
                             "--vae-quant", TOME_TURBO["vae_quant"]]
# the CLIP ViT-L/14 tower's bf16 features (the CLI's) against the same tower
# in fp32 on the same pixels, relative L2 over the whole output: bf16
# activations and weights through 24 pre-LN layers. On an NVIDIA H100 80GB
# HBM3 (700 W) the sound tower reads 1.117e-2 (last_hidden_state, run a) and 1.113e-2
# (image_embeds, run b) on its seeded weights and the synthetic structure
# image (PERF.md §5, PR 12); the band leaves 2.7x that
CLIP_REL_BAND = 3e-2
# LEACE fitted in the phase by scripts/torch_compute_leace_projection.py on a
# seeded tree of this many train PNGs in four class directories (the
# baseline model's ImageProjection gives 16 × 768 tokens an image)
LEACE_FIT_IMAGES = 32
# the kernels' shapes on the infer path that the 512², batch-8 path does not
# give them (run a: batch 13 at 512²; run b: 26 in the UNet with CFG, 13 in
# the VAE, at 256²); each kernel is held to its plain version at them,
# untimed, after the runs' launches are read
INFER_ATTN_SHAPES = [(13, 4096, 8, 40), (13, 1024, 8, 80), (13, 4096, 1, 512),
                     (26, 1024, 8, 40), (13, 1024, 1, 512)]
INFER_SPLIT3_SHAPES = [(13, 4096, 8, 40), (13, 1024, 8, 80), (13, 256, 8, 160)]
INFER_LN_SHAPES = [(13 * 4096, 320), (13 * 1024, 640), (13 * 256, 1280), (26 * 1024, 320),
                   (26 * 256, 640), (26 * 64, 1280)]
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
                       (4 * 1024, 320), (4 * 256, 640), (4 * 64, 1280)]
TRAIN_CLI_GN_SHAPES = [(64, 1024, 320), (64, 256, 640), (64, 64, 1280), (4, 1024, 320),
                       (4, 256, 640), (4, 64, 1280)]

# the product-loop phase: psd_tpu's tests/test_product_loop.py chain at full
# width on phase 6b's checkpoint and PNG tree, cut in depth only. The augment
# factory (configs/train_ip.yaml at 256², --batch-images 4: 12 images a UNet
# batch, 10 DDIM steps) over 127 of the 128 train PNGs: 381 jobs, 32 replays
# of one program, the last padded from 9; the evaluation sweep over two
# scales on the val split (4 images a class: 4 replays a scale, random
# backbones: no Inception or VGG weights in the repo); the classifier
# (configs/train_classifier.yaml: ResNet-18 at 224², batch 32, AdamW, label
# smoothing 0.1, clip 1.0) for 2 epochs on the synthetic-only train split
# (380 images after balancing: 11 optimizer steps an epoch), judged on the 32
# real val PNGs
LOOP_BATCH, LOOP_STEPS, LOOP_SCALES = 12, 10, (1.0, 2.0)
LOOP_AUGMENT = ["--batch-images", "4", "--sampling-steps", str(LOOP_STEPS), "--max-images", "127",
                "--copy-splits", "--seed", "0", "--ema"]
LOOP_EVALUATE = ["--split", "val", "--scales", *map(str, LOOP_SCALES), "--batch-images", "4",
                 "--sampling-steps", str(LOOP_STEPS), "--max-per-class", "4",
                 "--num-eval-seeds", "2", "--allow-random-backbones", "--seed", "0"]
LOOP_CLASSIFY = ["--config", "configs/train_classifier.yaml", "--epochs", "2",
                 "--save-top-k", "1"]
# the metric backbones' bf16 features on the card (evaluate's FeatureBank)
# against the same weights in fp32 on the CPU, relative L2 over the features
# of 2 real and 2 generated images. On an NVIDIA H100 80GB HBM3 (700 W) the
# sound backbones read 1.100e-2 (Inception), 8.31e-3 (VGG) and 1.173e-2
# (CLIP), and planted faults 0.1119 (Inception's branch pools counting the
# padding) and 2.526e-2 (VGG's 256² → 224² shrink without antialiasing)
# (PERF.md §6); each band sits between the two. CLIP's is the infer phase's
# CLIP_REL_BAND; its planted fault, the images' channels reversed, reads
# 0.6028. The processor's bytes rounded instead of truncated read 1.407e-2,
# inside bf16's noise: phase 6c holds those bytes to transformers' truncation
# byte for byte, as tests/test_torch_evaluate.py does on the CPU
BACKBONE_REL_BANDS = {"inception": 3e-2, "vgg": 1.5e-2, "clip": CLIP_REL_BAND}
# the kernels' shapes on this path that no earlier phase gives them (batch 12
# at 256²), held to their plain versions by their judges, not timed
LOOP_ATTN_SHAPES = [(12, 1024, 8, 40), (12, 1024, 1, 512)]
LOOP_SPLIT3_SHAPES = [(12, 1024, 8, 40), (12, 256, 8, 80)]
LOOP_LN_SHAPES = [(12 * 1024, 320), (12 * 256, 640), (12 * 64, 1280)]
LOOP_GN_SHAPES = [(12, 1024, 320), (12, 256, 640), (12, 64, 1280)]

# phase 6d: training across ranks. The run has one card and NCCL refuses
# two ranks on one device, so (a) two ranks share cuda:0 over a gloo group
# (torchrun; the worker pins them to cuda:0 and starts the group), at --dp 2
# and then --fsdp 2, and (b) one rank
# runs on NCCL, the production backend (--dp 1 in a world of 1). A global
# batch of 32 (16 a rank, so two 14.7 GB training states and their
# activations fit in 80 GB: the one cut, in batch) of configs/train_ip.yaml
# at full width, 256², one step each (cut in depth to keep the script in its
# clock), on the phase's own tree of PNGs; each run against the one-process
# run of the same argv (the reference; --dp 1 on NCCL bit for bit).
# One loader thread: with more, the augment's draws follow the threads'
# order (data/limuc.py), and two runs of one argv differ by more than the
# ranks do (two one-process runs read 2.2e-1 of the update apart; PERF.md).
RANKS_STEPS = 1
RANKS_ARGS = ["dataset.batch_size=32", "dataset.num_workers=1",
              "training.update_starting_at_step=0", "training.log_every_n_steps=1",
              "--max-steps", str(RANKS_STEPS)]
RANKS_TIMEOUT_S = 420
# against the reference: each step's loss and grad norm (relative), and the
# post-step parameters' difference relative to the reference's update
# (‖p − p₁‖ / ‖p₁ − p₀‖). The ranks' bf16 kernels run at batch
# 16 where the reference runs 32, so their sums round differently; the
# bands sit between the sound readings and a planted fault (every rank
# skipping the gradient average, `fault: no_average`; PERF.md §6, read at
# two steps): losses 1.5e-4 sound (1.1e-3 the fault's second step; the
# first loss, the one a one-step run logs, precedes any update), grad norms
# 1.3e-3 against 0.16, the update 3.9e-2 (FSDP2 5.8e-2 at one step, --dp 1
# on NCCL 0: the same rows) against 0.50.
RANKS_LOSS_RTOL, RANKS_NORM_RTOL, RANKS_UPDATE_BAND = 1e-3, 2e-2, 0.15
# the kernels at the rows a rank gives them (16), held to their plain
# versions untimed
RANKS_ATTN_SHAPES = [(16, 1024, 8, 40), (16, 1024, 1, 512)]
RANKS_SPLIT3_SHAPES = [(16, 1024, 8, 40), (16, 256, 8, 80)]
# phase 6e: the tp train step through the API (`shard_train_state` on a
# (dp 1, tp 2) mesh, `make_train_step`), in 6d's --dp 2 gloo launch after
# its step: configs/train_ip.yaml at full width, 256², a global batch of
# TRAIN_TP_BATCH (both tp ranks hold all its rows), one step, against the
# one-process step on the same initial state, batch and draws (rank 0 runs
# it first). The loss, the grad norm and the flattened update take 6d's
# bands (RANKS_*); the conditioning modules and one cut site's weights, small
# shares of the 920 M entries, are judged each on its own: ‖p − p₁‖ over
# ‖p₁ − p₀‖ within the module's band, set between the sound reading and the
# planted faults' (`phase_train_tp(card, trained, fault=True)`: f left off
# the context tokens; g all-reducing in its backward too; PERF.md §6, the
# int8 and tp train entry)
TRAIN_TP_BATCH = 16
TRAIN_TP_SITE = "unet.down_blocks_0_attentions_0.transformer_blocks_0"
TRAIN_TP_MODULES = {
    "ordinal_embedder": re.compile(r"ordinal_embedder\..*"),
    "image_projection": re.compile(r"image_projection\..*"),
    "feature_purifier": re.compile(r"feature_purifier\..*"),
    "attn1 q/k/v": re.compile(re.escape(TRAIN_TP_SITE) + r"\.attn1\.to_[qkv]\.weight"),
    "attn2 k/v": re.compile(re.escape(TRAIN_TP_SITE) + r"\.attn2\.to_[kv](_dis)?\.weight"),
    "net_2": re.compile(re.escape(TRAIN_TP_SITE) + r"\.ff\.net_2\.weight"),
}
# On an NVIDIA H100 80GB HBM3 (700 W) the sound run read 4.1e-2–9.4e-2 by
# module (7.5e-2 flattened); f off the context 0.995–1.03 at the
# conditioning modules (the cut site's weights as sound), g all-reducing
# backward 1.20–1.27 everywhere (grad norm 53.2 against 7.75; PERF.md §6,
# the int8 and tp train entry). The band sits between.
TRAIN_TP_MODULE_BAND = 0.3
# the context tokens at SD scale (16 AOE + 16 image + 16 delta): how the
# planted fault tells them from a site's hidden tokens (1024, 256, 64, 16)
TRAIN_TP_CONTEXT_TOKENS = 48
# each rank's kernels at the tp step's shapes (its 16 rows, H/tp = 4 heads):
# the attention forward with its lse and the backward at the 32×32 sites,
# split3's autograd.Function at 32² and 16²; timed, kept under
# "tp_train_shapes" outside the entries' sums
TRAIN_TP_ATTN_SHAPES = [(16, 1024, 4, 40)]
TRAIN_TP_SPLIT3_SHAPES = [(16, 1024, 4, 40), (16, 256, 4, 80)]

# phase 7: the port's quality gates (scripts/torch_check_*.py) at
# configs' width, cut in size only: the stride gate at 512² (ToMe merges
# only at the 64² sites), the distribution gate at 256², the int8 gate at
# its defaults and its decode mode at 512²; the stride gate synth-trains
# the model GATES_TRAIN_STEPS steps, and the distribution gate, which asks
# for the same run, and the int8 gate's core take those weights
GATES_TRAIN_STEPS = 20
GATES_STRIDE = ["--size", "512", "--batch", "8", "--steps", "10",
                "--train-steps", str(GATES_TRAIN_STEPS), "--variants", "deep5,tome0.5,dpm5+deep5"]
GATES_DIST = ["--size", "256", "--batch", "8", "--images", "16", "--repeats", "2",
              "--train-steps", str(GATES_TRAIN_STEPS), "--variants", "deep5,int8"]
GATES_INT8 = [[], ["--vae", "--size", "512", "--batch", "8"]]
# the kernels at the gates' shapes beyond phases 3 and 5e's: batch 8 and 4
# at 256² (the distribution and int8 gates; synth-train's batch-8 training
# shapes are phase 6's accumulation check's)
GATES_ATTN_SHAPES = [(8, 1024, 8, 40), (8, 256, 8, 80), (8, 1024, 1, 512),
                     (4, 1024, 8, 40), (4, 256, 8, 80), (4, 1024, 1, 512)]
GATES_SPLIT3_SHAPES = [(8, 1024, 8, 40), (8, 256, 8, 80), (4, 1024, 8, 40), (4, 256, 8, 80)]
GATES_LN_SHAPES = [(8 * 1024, 320), (8 * 256, 640), (8 * 64, 1280), (4 * 1024, 320),
                   (4 * 256, 640), (4 * 64, 1280)]
GATES_GN_SHAPES = [(8, 1024, 320), (8, 256, 640), (8, 64, 1280), (4, 1024, 320),
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


def _load_script(name: str):
    """scripts/<name>.py as a module, to call its main() in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _delta(value: float) -> torch.Tensor:
    """δ as the model hands it to split3: a 0-d fp32 tensor on the card,
    which the kernel reads from device memory."""
    return torch.tensor(value, dtype=torch.float32, device="cuda")


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


def _split3_replay_probe(gen) -> None:
    """δ read from device memory under a CUDA graph: one split3 launch at
    SPLIT3_SHAPES[1] captured with its δ scalar at 1.0, then, for each of
    SPLIT3_PROBE_DELTAS, the new δ written into that scalar and the graph
    replayed. Each replay must equal a direct launch at that δ bit for bit,
    and differ from the captured δ's output (so the probe could fail: a
    kernel that took δ by value would replay 1.0)."""
    from psd_tpu_torch.ops import split3

    dev = torch.device("cuda")
    B, S, H, D = SPLIT3_SHAPES[1]
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
    banks = [torch.randn((B, 16, H, D), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(6)]
    delta = _delta(1.0)
    captured = split3.split3_fwd(q, *banks, delta, 0.1, 0.9)  # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = split3.split3_fwd(q, *banks, delta, 0.1, 0.9)
    readings = {}
    for value in SPLIT3_PROBE_DELTAS:
        delta.fill_(value)
        graph.replay()
        direct = split3.split3_fwd(q, *banks, _delta(value), 0.1, 0.9)
        torch.cuda.synchronize()
        readings[value] = (torch.equal(out, direct), not torch.equal(out, captured))
    ok = all(a and b for a, b in readings.values())
    log(f"[kernel] split3 replay probe {(B, S, H, D)}: one launch captured at delta 1.0, "
        f"replayed after a new delta is written into its scalar; (bit-equal to a direct launch "
        f"at that delta, differs from delta 1.0's output) {readings} {'ok' if ok else 'FAIL'}")
    del graph
    if not ok:
        raise SystemExit("chip_smoke.py: a split3 launch replayed from a CUDA graph does not "
                         "read the delta written after its capture")


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
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, d1, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2 + 4),
                 judge=split3_judge,
                 note={"device_ms": graph_ms(lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9)),
                       "wrapper_host_ms": host_ms(
                           lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9))})
    # the edge inputs draw from generators of their own, so the inputs of
    # the shapes after them stay those of earlier runs
    gs = torch.Generator(device=dev).manual_seed(11)
    for (B, S, H, D), lens, delta in SPLIT3_EDGE:
        q = torch.randn((B, S, H, D), generator=gs, device=dev).to(bf)
        banks = [torch.randn((B, n, H, D), generator=gs, device=dev).to(bf)
                 for n in lens for _ in range(2)]
        dl = _delta(delta)
        ok, text, _ = split3_judge(split3.split3_fwd(q, *banks, dl, 0.5, 0.5),
                                   split3.split3_reference(q, *banks, dl, 0.5, 0.5))
        log(f"[kernel] split3 edge {str((B, S, H, D)):20s} banks {lens} delta {delta:g} "
            f"(plan {split3.split3_plan(H, D, B * S, split3._sm_count(dev))}): {text} "
            f"{'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: split3 edge {(B, S, H, D)} banks {lens} disagrees "
                             f"with its plain version")
    _split3_replay_probe(gs)
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


# ---- published checkpoints (phase 4b) ------------------------------------------
def _published_state(surface, seed: int, dtype=torch.float32) -> dict:
    """{key: CPU tensor} over `surface` ({key: (shape, torch dtype)}), drawn
    on the card from `seed`: weights of rank ≥ 2 N(0, 1/fan_in) in `dtype`,
    biases and running means 0, other vectors (norms, running variances,
    CLIP's class embedding) 1, integer counters 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for key, (shape, kind) in surface.items():
        if not kind.is_floating_point:
            out[key] = torch.zeros(shape, dtype=kind)
        elif key.endswith((".bias", "running_mean")):
            out[key] = torch.zeros(shape, dtype=dtype)
        elif len(shape) >= 2:
            w = torch.randn(shape, generator=g, device="cuda") * math.prod(shape[1:]) ** -0.5
            out[key] = w.to(dtype).cpu()
        else:
            out[key] = torch.ones(shape, dtype=dtype)
    return out


def _write_safetensors(path: Path, tensors: dict) -> None:
    """The .safetensors format (the `safetensors` package is not needed): a
    little-endian u64 header length, the JSON header with `__metadata__`,
    then each tensor's bytes in the header's order."""
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(len(blob).to_bytes(8, "little"))
        fh.write(blob)
        for t in tensors.values():
            fh.write(t.contiguous().view(torch.uint8).numpy().data)


def _write_published(work: Path) -> dict:
    """The phase's checkpoint files under `work`; → seconds and bytes a file."""
    import importlib

    from psd_tpu_torch.convert import manifest

    bb = importlib.import_module("tests.torch_ref.backbones")
    f32 = torch.float32

    def of_manifest(m):
        return {k: (shape, f32) for k, shape in m.items()}

    def of_mirror(ctor, *args):
        with torch.device("meta"):
            module = ctor(*args)
        return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}

    files = {
        "unet.safetensors": (of_manifest(manifest.sd_unet_manifest()), torch.float16),
        "vae.safetensors": (of_manifest(manifest.sd_vae_manifest()), f32),
        "clip.bin": (of_manifest(manifest.clip_vision_manifest()), f32),
        "resnet50.pth": (of_mirror(bb.TorchResNet, bb.Bottleneck, [3, 4, 6, 3]), f32),
        "vgg16.pth": (of_mirror(bb.TorchVGG16), f32),
        "inception.pth": (of_mirror(bb.TorchInceptionV3), f32),
    }
    written = {}
    for seed, (name, (surface, dtype)) in enumerate(files.items()):
        t0 = time.perf_counter()
        tensors = _published_state(surface, seed, dtype)
        if name.endswith(".safetensors"):
            _write_safetensors(work / name, tensors)
        else:
            torch.save(tensors, work / name)
        written[name] = {"s": round(time.perf_counter() - t0, 2),
                         "GB": round((work / name).stat().st_size / 1e9, 3)}
        del tensors
    return written


def _swap_kh_kw_(module, name: str) -> None:
    """The planted fault: the 3×3 conv `name`'s kernel with kh and kw
    swapped, as a converter's layout slip would write it (its own inverse)."""
    conv = module.get_submodule(name)
    with torch.no_grad():
        conv.weight.copy_(conv.weight.transpose(2, 3).clone())


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


def _judge_shapes(tag: str, attn_shapes, ln_shapes, gn_shapes, seed: int) -> None:
    """Each kernel of a phase's path against its plain version by its judge
    at that path's shapes: attention at `attn_shapes` (B, S, H, D), ln_proj
    and ln_geglu at `ln_shapes` (M, C), gn_proj at `gn_shapes` (B, S, C)
    (not timed, not counted)."""
    from psd_tpu_torch.ops import attention
    from psd_tpu_torch.testing import attention_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    for shape in attn_shapes:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        ok, text, _ = attention_judge(attention.attention_fwd(q, k, v),
                                      attention.attention_reference(q, k, v))
        log(f"[{tag}] attention {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: attention {shape} disagrees with its plain version")
    for M, C in ln_shapes:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in gn_shapes:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def phase_weights(card: str) -> dict:
    """Published checkpoints into the port without JAX (phase 4b): files in
    the published formats at SD-v1.4 width, each converted by
    scripts/torch_port_weights.py; the converted UNet (plain) and VAE in bf16
    on the kernels against the diffusers-named mirror's fp32 forward on the
    CPU, each beside a planted kh/kw fault; then the evaluation sweep reading
    the converted Inception and VGG through its flags, its loaded weights
    held to the npz key by key. The launches count from 0 before the held
    eps and decode, and before the CLI."""
    import shutil
    from unittest import mock

    import numpy as np

    from psd_tpu_torch.convert.from_jax import (_leaves, load_flax_, to_flax_variables,
                                                vae_decode_tree)
    from psd_tpu_torch.convert.npz import load_params_npz
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import KERNELS, disable_kernels
    from psd_tpu_torch.convert.sd import load_torch_state_dict
    from psd_tpu_torch.models.layers import store_weights_in_
    from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config
    from psd_tpu_torch.models.vae import VAEDecode, sd_vae_config
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines import evaluate
    from psd_tpu_torch.testing import route_launches
    from tests.torch_ref.unet import TorchUNet2DConditionModel
    from tests.torch_ref.vae import TorchAutoencoderKL

    work = ROOT / "build" / "psd_tpu_torch" / "weights"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda")
    try:
        written = _write_published(work)
        log(f"[weights] wrote the published files (seconds, GB): {written}")

        script = _load_script("torch_port_weights")
        converted, held = {}, {}
        for kind, src in WEIGHTS_KINDS:
            out = work / f"{kind}.npz"
            t0 = time.perf_counter()
            tree = script.main(["--kind", kind, "--src", str(work / src), "--out", str(out)])
            converted[kind] = {"s": round(time.perf_counter() - t0, 2),
                               "GB": round(out.stat().st_size / 1e9, 3),
                               "leaves": sum(1 for _ in _leaves(tree)),
                               "gate": kind in script.GATED_KINDS}
            if kind in WEIGHTS_BANDS:  # the trees the script wrote, for the hold
                held[kind] = tree
            del tree
        log(f"[weights] scripts/torch_port_weights.py, each kind (seconds, npz GB, leaves, "
            f"through the meta-device gate): {converted}")

        g = torch.Generator().manual_seed(0)
        L = WEIGHTS_LATENT
        x = torch.randn((1, L, L, 4), generator=g)
        t = torch.tensor([500])
        ctx = torch.randn((1, 48, 768), generator=g)
        z = torch.randn((1, L, L, 4), generator=g)

        # the port's modules, bf16 on the card, with the converted weights
        t0 = time.perf_counter()
        with dev:
            unet = UNet2DCondition(sd14_unet_config(attn_mode="plain")).eval()
            vae = VAEDecode(sd_vae_config()).eval()
        load_flax_(unet, held.pop("unet"))
        load_flax_(vae, vae_decode_tree(held.pop("vae")))
        store_weights_in_(unet, torch.bfloat16)
        store_weights_in_(vae, torch.bfloat16)
        load_s = time.perf_counter() - t0

        def eps():
            return unet(x.to(dev), t.to(dev), ctx.to(dev), 0.0).permute(0, 3, 1, 2).float().cpu()

        def decode():
            return vae(z.to(dev)).permute(0, 3, 1, 2).float().cpu()

        with torch.inference_mode():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = {"unet": eps(), "vae": decode()}
            torch.cuda.synchronize()
            counts = dict(kernels.launch_counts)
            head_dims = dict(kernels.attention_head_dims)
            with disable_kernels(*KERNELS):
                plain = {"unet": eps(), "vae": decode()}
            faulty = {}
            for kind, module, run in (("unet", unet, eps), ("vae", vae, decode)):
                _swap_kh_kw_(module, WEIGHTS_FAULTS[kind])
                faulty[kind] = run()
                _swap_kh_kw_(module, WEIGHTS_FAULTS[kind])
        del unet, vae
        gc.collect()
        torch.cuda.empty_cache()

        # the mirrors' fp32 forwards on the CPU, over the files' state dicts
        cpu_s = {}
        with torch.no_grad():
            for kind, ctor, src in (("unet", TorchUNet2DConditionModel, "unet.safetensors"),
                                    ("vae", TorchAutoencoderKL, "vae.safetensors")):
                with torch.device("meta"):
                    mirror = ctor()
                mirror.load_state_dict({k: torch.from_numpy(v) for k, v in
                                        load_torch_state_dict(work / src).items()}, assign=True)
                t0 = time.perf_counter()
                if kind == "unet":
                    ref = mirror.eval()(x.permute(0, 3, 1, 2), t, ctx)
                else:
                    ref = mirror.eval().decode(z.permute(0, 3, 1, 2))
                cpu_s[kind] = round(time.perf_counter() - t0, 2)
                readings = (_rel_l2(got[kind], ref), _rel_l2(faulty[kind], ref),
                            _rel_l2(plain[kind], ref), _rel_l2(got[kind], plain[kind]))
                cpu_s[f"{kind}_rel"] = readings
                if not bool(torch.isfinite(got[kind]).all()) or got[kind].shape != ref.shape:
                    raise SystemExit(f"chip_smoke.py: the converted {kind} gave "
                                     f"{tuple(got[kind].shape)}, finite "
                                     f"{bool(torch.isfinite(got[kind]).all())}")
                del mirror, ref
                gc.collect()
        bands = {k: cpu_s.pop(f"{k}_rel") for k in WEIGHTS_BANDS}
        log(f"[weights] the converted files on the kernels (bf16, one eps at t 500 and one "
            f"decode of (1, {L}, {L}, 4)) against the mirror's fp32 forward on the CPU: relative "
            f"L2 sound / planted kh-kw fault / every kernel off; kernels against plain " + ", ".join(
                f"{k} {bands[k][0]:.4e} / {bands[k][1]:.4e} / {bands[k][2]:.4e}; {bands[k][3]:.4e} "
                f"(band {WEIGHTS_BANDS[k]:g}, fault at {WEIGHTS_FAULTS[k]})" for k in bands)
            + f"; load {load_s:.2f} s; mirror CPU seconds {cpu_s}; launches {counts}, "
            f"attention by head dim {head_dims}; on {card}")

        # the evaluation sweep from the converted backbones, through its flags
        _write_tree(work / "data", WEIGHTS_EVAL_IMAGES)
        loaded, models = {}, []
        load_variables, model_for = evaluate.load_variables_, evaluate.model_for

        def loading(net, tree):
            load_variables(net, tree)
            loaded[type(net).__name__] = to_flax_variables(net)
            return net

        def building(*a):
            models.append(model_for(*a))
            return models[-1]

        with mock.patch.multiple(evaluate, load_variables_=loading, model_for=building):
            results, counts_e, dims_e, wall_e = _counted(evaluate.main, [
                "--config", str(ROOT / "configs" / "train_ip.yaml"),
                "--data-dir", str(work / "data"), "--output-dir", str(work / "eval"),
                "--inception-params", str(work / "inception.npz"),
                "--vgg-params", str(work / "vgg16.npz"), *WEIGHTS_EVALUATE])
        size = load_config(ROOT / "configs" / "train_ip.yaml").dataset.image_size
        per_batch = route_launches(models[0].core_cfg, models[0].vae_cfg, 12, size, 2)
        del models
        gc.collect()
        torch.cuda.empty_cache()

        def same(net, npz):
            want = dict(_leaves(load_params_npz(work / npz)))
            have = dict(_leaves(loaded[net]))
            return sorted(have) == sorted(want) and all(
                have[k].dtype == want[k].dtype and np.array_equal(have[k], want[k]) for k in want)

        checks = {
            f"unet within {WEIGHTS_BANDS['unet']:g}, its fault beyond":
                bands["unet"][0] <= WEIGHTS_BANDS["unet"] < bands["unet"][1],
            f"vae within {WEIGHTS_BANDS['vae']:g}, its fault beyond":
                bands["vae"][0] <= WEIGHTS_BANDS["vae"] < bands["vae"][1],
            "kernels against plain within the bands": all(
                bands[k][3] <= WEIGHTS_BANDS[k] for k in bands),
            "WEIGHTS_ATTN_SHAPES cover the head dims launched":
                sorted(head_dims) == sorted({s[3] for s in WEIGHTS_ATTN_SHAPES}),
            "the held eps and decode launched attention (D=40, 80, 512), ln_proj, ln_geglu, "
            "gn_proj": all(counts.get(k, 0) > 0 for k in ("attention", "ln_proj", "ln_geglu",
                                                            "gn_proj"))
                and all(head_dims.get(d, 0) > 0 for d in (40, 80, 512)),
            "evaluate loaded the converted Inception and VGG, key by key":
                same("InceptionV3Features", "inception.npz") and same("VGG16Features",
                                                                       "vgg16.npz"),
            "evaluate's metrics finite": all(np.isfinite(v) for r in results for v in
                                             r.overall.values()),
            f"evaluate launches 2 x {per_batch} (warm-up and capture)":
                counts_e == {k: 2 * per_batch.get(k, 0) for k in counts_e},
        }
        log(f"[weights] evaluate --inception-params --vgg-params (the converted npz): wall "
            f"{wall_e:.2f} s, overall {results[0].overall}; launches {counts_e}, by head dim "
            f"{dims_e}; on {card}")
        log(f"[weights] checks {checks}")
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke.py: weights checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
        _judge_shapes("weights", WEIGHTS_ATTN_SHAPES, WEIGHTS_LN_SHAPES, WEIGHTS_GN_SHAPES, 31)
        return {"counts": counts, "head_dims": head_dims, "bands": bands, "written": written,
                "converted": converted, "cli": {"counts": counts_e, "head_dims": dims_e}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    """One replay of a captured program (replayed before, so warm): its
    device time (CUDA events around the replay) and the host time until
    `replay()` returns (the graph's launch), each the median of the same `n`
    replays."""
    device, host = [], []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        prog.graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return {"device_ms": statistics.median(device), "host_launch_ms": statistics.median(host)}


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


def _serve_requests(batch: int = 8) -> list:
    """Phase 5's requests, (feats, target, source, seed) each: two batches of
    `batch`, each led by its own seed (phase 5d serves the first 12)."""
    import numpy as np

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2 * batch, 257, 1024)).astype(np.float32)
    targets = np.tile(np.linspace(0.0, 3.0, batch), 2)
    return [(feats[i], targets[i], 1.0, i if i < batch else 100 + i) for i in range(2 * batch)]


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
    requests = _serve_requests(batch)
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
    # phase 5d's requests: a full batch and one of 4 padded to 8
    images12, _ = _serve(server, requests[:SERVE_RANKS_REQUESTS])
    _close(server, "graph")
    # and at 5d's depth, its reference; that program is dropped after
    held = set(model.programs)
    rserver = GenerationServer(model, image_size=size, sampling_steps=SERVE_RANKS_STEPS,
                               steer_scale=1.0, max_batch=batch, max_wait_s=0.05)
    images12_ranks, _ = _serve(rserver, requests[:SERVE_RANKS_REQUESTS])
    _close(rserver, f"{SERVE_RANKS_STEPS} steps")
    for key in set(model.programs) - held:
        del model.programs[key]

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
        # first, again, two pipelined, phase 5d's two: six replays of one
        # program; the eager server replays nothing, fused=False one
        # program of each kind
        "one replay a batch (fused=True)": prog.replays == 6,
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
    log(f"[serve] max abs difference {diffs}; phase 5d's 12 requests (the second batch padded "
        f"from 4) against the same requests in two full batches: "
        f"{_max_diff(images12, images16[:12])}; fused=False: sample warm-up "
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
    del server, eserver, userver, prog, sprog, dprog, probe
    gc.collect()  # the probes' wrappers hold their servers in cycles
    torch.cuda.empty_cache()
    failure = _check_capture_failure()
    # phase 5g replays this model's generate program (captured at steer 1.0)
    return {"model": model, "counts": counts, "head_dims": dims, "replay_launches": launches,
            "images12": images12, "images12_ranks": images12_ranks, "wall_s": wall_replay,
            "img_per_s": batch / wall_replay,
            "ab": ab,
            "replay_ms": replay_ms, "diffs": diffs, "failure": failure,
            "memory_gib": {"first_peak": peak_first, "replay_peak": peak_replay,
                           "eager_peak": peak_eager, **mem_graph}}


# ---- scalars -----------------------------------------------------------------
def _replay_skipping(prog, inputs, skip: int):
    """A planted fault: replay `prog` after copying in every input but
    input `skip`, which keeps the value the program last ran with."""
    with torch.inference_mode():  # the static inputs are inference tensors
        for i, (static, t) in enumerate(zip(prog.inputs, inputs)):
            if i != skip:
                static.copy_(t)
        prog.graph.replay()
        return prog.output.clone()


class _CaptureCounter:
    """Counts the programs DADD captures while it is entered (a stand-in for
    `diffusion.dadd.CapturedProgram` that builds the real one)."""

    def __enter__(self):
        from psd_tpu_torch.diffusion import dadd

        self.module, self.real, self.n = dadd, dadd.CapturedProgram, 0

        def counting(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        dadd.CapturedProgram = counting
        return self

    def __exit__(self, *exc):
        self.module.CapturedProgram = self.real


def _sweep(model, call: dict, name: str, values, fault: tuple, label: str) -> dict:
    """`model.generate(**call, name=v)` for each v of `values`, by graph
    replay, each against an eager generate at v bit for bit; each replay's
    wall (synced) and device time (CUDA events around the call: the copies
    in, the replay, the copy out). The planted fault `fault` = (after,
    value): once `values[:after]` have run, a replay at `value` that skips
    the copy of `name`'s input, so it runs at the value the program holds.
    `_sample_program` puts steer and guidance last, in that order. The
    launch counts are set to 0 after the eager references and read after
    the sweep: a capture's warm-up and capture count, replays do not."""
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.diffusion.graphs import program_key
    from psd_tpu_torch.ops import kernels

    knobs = model.static_knobs(call["sampling_steps"], 1, "encoder", "ddim")
    scalars = {"steer_scale": call.get("steer_scale", 0.0),
               "guidance_scale": call.get("guidance_scale", 1.0)}

    def inputs_at(v):
        at = {**scalars, name: v}
        return model._sample_program(call["cond"], call["x0"], call.get("cond_uncond"), None,
                                     at["steer_scale"], at["guidance_scale"], knobs)[0]

    refs = {}
    with eager():
        for v in set(values) | {fault[1]}:
            refs[v] = model.generate(**call, **{name: v})
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    readings, images, caught = {}, {}, None
    for i, v in enumerate(values):
        if i == fault[0]:
            fin = inputs_at(fault[1])
            prog = model.programs[program_key("generate", fin, **knobs)]
            skip = len(fin) - (2 if name == "steer_scale" else 1)
            caught = not torch.equal(_replay_skipping(prog, fin, skip), refs[fault[1]])
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = model.generate(**call, **{name: v})
        stop.record()
        torch.cuda.synchronize()
        readings[v] = {"wall_s": time.perf_counter() - t0,
                       "device_ms": start.elapsed_time(stop),
                       "equal_to_eager": bool(torch.equal(out, refs[v]))}
        images[v] = out.cpu().numpy()
    counts = {k: n for k, n in kernels.launch_counts.items() if n}
    head_dims = dict(kernels.attention_head_dims)
    prog = model.programs[program_key("generate", inputs_at(values[0]), **knobs)]
    log(f"[scalars] {label}: {name} " + "; ".join(
        f"{v:g} wall {r['wall_s']:.3f} s, device {r['device_ms']:.2f} ms, bit-equal to eager "
        f"{r['equal_to_eager']}" for v, r in readings.items())
        + f"; planted fault (a replay at {fault[1]:g} that skips the {name} copy) caught: "
        f"{caught}; host launches over the sweep {counts}")
    return {"values": readings, "images": images, "fault_caught": bool(caught), "program": prog,
            "counts": counts, "head_dims": head_dims}


def phase_scalars(card: str, served: dict) -> dict:
    """Steer and guidance as device scalars: one captured program serves a
    sweep. (a) Phase 5's model and its generate program (captured at steer
    1.0 by the server): 8 requests whose source and target labels differ (the
    delta tokens are zero where they are equal, and δ would change nothing),
    replayed at each of SCALARS_STEERS without a new capture, each bit-equal
    to an eager generate at that δ; the images at 0.3 and 2.0 apart by more
    than SCALARS_DIFF_FLOOR; the planted fault, a replay at 0.3 that skips
    the steer copy (so it runs at the captured 1.0), caught. (b) Baseline
    mode with CFG (configs/train.yaml at 256², batch 8, a UNet batch of 16,
    SCALARS_CFG_STEPS DDIM steps): one program captured at the first of
    SCALARS_GUIDANCES and replayed at each, bit-equal to eager, the same
    fault on the guidance caught, and the kernels' launches those
    route_launches gives (twice over the sweep: warm-up and capture), each
    kernel at (b)'s shapes held to its plain version (SCALARS_*)."""
    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.testing import route_launches

    model = served.pop("model")
    rng = np.random.default_rng(5)
    batch, size = 8, 512
    feats = rng.standard_normal((batch, 257, 1024)).astype(np.float32)
    targets = np.linspace(0.5, 3.0, batch).astype(np.float32)
    sources = np.where(np.arange(batch) % 2 == 0, 0.0, 3.5 - targets).astype(np.float32)
    if np.any(targets == sources):
        raise SystemExit("chip_smoke.py: scalars: a request whose source equals its target")
    gen = torch.Generator(device="cuda").manual_seed(21)
    call = dict(cond=model.prepare_inference_cond(targets, sources, feats),
                x0=model.initial_noise(batch, size, gen, shared_noise=False), image_size=size,
                sampling_steps=model.cfg.diffusion.sampling_steps)
    (prog,) = _programs(model, "generate")
    n_programs, replays0 = len(model.programs), prog.replays
    with _CaptureCounter() as captures:
        a = _sweep(model, call, "steer_scale", SCALARS_STEERS, (0, 0.3),
                   f"(a) exact path, {size}², batch {batch}, {call['sampling_steps']} DDIM steps")
    diff = np.abs(a["images"][0.3].astype(np.float64) - a["images"][2.0])
    apart = {"mean": float(diff.mean()), "max": float(diff.max())}
    checks_a = {
        "no new capture": captures.n == 0 and len(model.programs) == n_programs,
        "phase 5's program replayed, once a value":
            a["program"] is prog and prog.replays == replays0 + len(SCALARS_STEERS),
        "each replay bit-equal to eager": all(r["equal_to_eager"] for r in a["values"].values()),
        f"0.3 and 2.0 apart by more than {SCALARS_DIFF_FLOOR:g} (mean abs)":
            apart["mean"] > SCALARS_DIFF_FLOOR,
        "planted fault (steer copy skipped) caught": a["fault_caught"],
        "no kernel launched on the host (replays only)": a["counts"] == {},
    }
    log(f"[scalars] (a) the program's one capture (phase 5, steer 1.0): warm-up "
        f"{prog.warmup_s:.3f} s + capture {prog.capture_s:.3f} s + instantiation "
        f"{prog.instantiate_s:.3f} s, peak allocated {served['memory_gib']['first_peak']:.3f} GiB "
        f"(phase 5's first batch); images at 0.3 and 2.0 apart {apart}; checks {checks_a}")
    del model, prog, a, call
    gc.collect()
    torch.cuda.empty_cache()

    _judge_shapes("scalars", SCALARS_ATTN_SHAPES, SCALARS_LN_SHAPES, SCALARS_GN_SHAPES, 41)
    cfg = load_config(ROOT / "configs" / "train.yaml", ["dataset.image_size=256"])
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=1)
    want = route_launches(model.core_cfg, model.vae_cfg, batch, 256, SCALARS_CFG_STEPS,
                          cfg_pass=True)
    feats = rng.standard_normal((batch, model.core_cfg.clip_projection_dim)).astype(np.float32)
    tgt, src = np.linspace(0.0, 3.0, batch).astype(np.float32), np.zeros(batch, np.float32)
    call = dict(cond=model.prepare_inference_cond(tgt, src, feats),
                cond_uncond=model.prepare_inference_cond(tgt, src, feats, zero_aoe=True),
                x0=model.initial_noise(batch, 256, gen, shared_noise=True), image_size=256,
                sampling_steps=SCALARS_CFG_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _CaptureCounter() as captures:
        b = _sweep(model, call, "guidance_scale", SCALARS_GUIDANCES,
                   (1, SCALARS_GUIDANCES[1]),
                   f"(b) baseline mode with CFG, 256², batch {batch} (UNet {2 * batch}), "
                   f"{SCALARS_CFG_STEPS} DDIM steps")
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    prog, b_counts, b_dims = b["program"], b["counts"], b["head_dims"]
    checks_b = {
        "one capture": captures.n == 1 and len(model.programs) == 1,
        "each replay bit-equal to eager": all(r["equal_to_eager"] for r in b["values"].values()),
        "planted fault (guidance copy skipped) caught": b["fault_caught"],
        f"host launches 2 x route_launches {want} (warm-up and capture)":
            b["counts"] == {k: 2 * n for k, n in want.items() if n},
        "a replay launches route_launches": dict(prog.launches) == {
            k: n for k, n in want.items() if n},
        "every kernel of the path launched": all(
            want[k] > 0 for k in ("attention", "ln_proj", "ln_geglu", "gn_proj")),
    }
    log(f"[scalars] (b) its one capture (at guidance {SCALARS_GUIDANCES[0]:g}): warm-up "
        f"{prog.warmup_s:.3f} s + capture {prog.capture_s:.3f} s + instantiation "
        f"{prog.instantiate_s:.3f} s; peak allocated over (b) {peak_b:.3f} GiB; checks "
        f"{checks_b}; on {card}")
    del model, prog, b, call
    gc.collect()
    torch.cuda.empty_cache()
    checks = {**{f"a {k}": v for k, v in checks_a.items()},
              **{f"b {k}": v for k, v in checks_b.items()}}
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: scalars checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    # the sweeps' host launches, (a)'s none: (b)'s warm-up and capture
    return {"apart": apart, "checks": checks, "counts": {k: b_counts.get(k, 0) for k in KERNELS},
            "head_dims": b_dims}


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
    steps = args.sampling_steps or model.cfg.diffusion.sampling_steps
    expected = route_launches(model.core_cfg, model.vae_cfg, INFER_LEVELS, size,
                              *_full_shallow(steps, args.encoder_stride, args.cache_mode),
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
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in INFER_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
            split3.split3_reference(q, *banks, d1, 0.1, 0.9))))
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
    `_device_busy`'s busy ms, activities and profiled wall ms."""
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.pipelines.infer import initial_draws

    steps = model.cfg.diffusion.sampling_steps
    x0, _ = initial_draws(model, INFER_LEVELS, 512, steps, 0.0, 0)

    def run():
        with eager():
            model.generate(cond, x0=x0, image_size=512, sampling_steps=steps, steer_scale=1.0)

    return _device_busy(run)


def phase_infer(card: str) -> dict:
    """The MES progression CLI (psd_tpu_torch.pipelines.infer.main) on the
    card: run (a) the README's command at 512² (routing gates, 13 levels,
    steer 1.0) and one batch-13 UNet eps on its conditioning, kernels
    against all plain; run (b) baseline mode at 256² with CFG 3.0, eta 0.5
    and a LEACE npz fitted here."""
    import shutil

    import numpy as np
    from PIL import Image

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

    # LEACE fitted by scripts/torch_compute_leace_projection.py through the
    # baseline model (fp32, as psd_tpu's script) on a seeded tree of PNGs
    shutil.rmtree(work / "leace_tree", ignore_errors=True)
    _write_tree(work / "leace_tree", {"train": LEACE_FIT_IMAGES})
    leace_script = _load_script("torch_compute_leace_projection")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leace = leace_script.main(["--config", str(ROOT / "configs" / "train.yaml"), "--data-dir",
                               str(work / "leace_tree"), "--output", str(work / "leace.npz"),
                               "--seed", "0"])
    fit_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    b = _infer_run("b", INFER_RUN_B + ["--leace", str(work / "leace.npz")], work / "b", card,
                   structure)
    fit_ok = (leace["P_null"].shape == (16 * 768, 16 * 768)
              and all(math.isfinite(v) for v in leace["stats"].values())
              and leace["stats"]["dist_after"] < leace["stats"]["dist_before"])
    b["checks"][f"LEACE fitted by the script on {LEACE_FIT_IMAGES} PNGs, finite, the class "
                f"means closer after"] = fit_ok
    log(f"[infer] run b: LEACE fitted by scripts/torch_compute_leace_projection.py "
        f"(configs/train.yaml, fp32, {LEACE_FIT_IMAGES} PNGs in four classes) in {fit_s:.3f} s "
        f"with the model's build; stats {leace['stats']}; CFG batch in the UNet "
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


def _lever_kernels(results: dict) -> None:
    """Each kernel at the shapes the levers give it (LEVER_*), against its
    plain version by its judge, timed as phase 3 times it (kernel, plain,
    library, bound; beside the LayerNorm GEMMs the cuBLAS product of the
    same size, kept as `cublas_product_ms`); kept under "levers_shapes",
    outside the entries' sums."""
    from psd_tpu_torch.ops import attention, geglu, split3
    from psd_tpu_torch.testing import attention_judge, ln_gemm_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    for shape in LEVER_ATTN_SHAPES:
        B, S, H, D = shape
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        _compare("attention", shape, lambda: attention.attention_fwd(q, k, v),
                 lambda: attention.attention_reference(q, k, v), results,
                 (4.0 * B * H * S * S * D, 4 * B * S * H * D * 2),
                 fn_library=lambda: _sdpa(q, k, v), judge=attention_judge,
                 note={"exp2_ms_at_sfu_rate": B * H * S * S / sfu_exp2_per_s() * 1e3},
                 key="levers_shapes")
        del q, k, v
        torch.cuda.empty_cache()
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in LEVER_SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, d1, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2),
                 judge=split3_judge, key="levers_shapes")
    for (M, C, n_out) in LEVER_LN_PROJ_SHAPES:
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        ws = tuple(randn(C, C, std=C ** -0.5) for _ in range(n_out))
        xhat, wcat = geglu.ln_reference(x, lw, lb), torch.cat(ws)  # the cuBLAS yardstick
        _compare("ln_proj", (M, C, n_out), lambda: geglu.ln_proj_fwd(x, lw, lb, ws),
                 lambda: geglu.ln_proj_reference(x, lw, lb, ws), results,
                 (2.0 * M * C * C * n_out,
                  M * C * 2 + 2 * C * 4 + n_out * (C * C * 2 + M * C * 2)),
                 judge=ln_gemm_judge, key="levers_shapes",
                 extra={"cublas_product_ms": time_ms(lambda: torch.matmul(xhat, wcat.T))})
    for (M, C) in LEVER_LN_GEGLU_SHAPES:
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        w0 = randn(8 * C, C, std=C ** -0.5)
        b0 = randn(8 * C, std=0.02, dtype=torch.float32)
        xhat = geglu.ln_reference(x, lw, lb)
        _compare("ln_geglu", (M, C), lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                 lambda: geglu.ln_geglu_reference(x, lw, lb, w0, b0), results,
                 (2.0 * M * C * 8 * C,
                  M * C * 2 + 2 * C * 4 + 8 * C * C * 2 + 8 * C * 4 + M * 4 * C * 2),
                 judge=ln_gemm_judge, key="levers_shapes",
                 extra={"cublas_product_ms": time_ms(lambda: torch.matmul(xhat, w0.T))})
    torch.cuda.empty_cache()


def _per_k_int8_(unet, fp32) -> int:
    """The planted fault of the int8 eps band: every square int8 projection
    (q, k, v, out, proj_in, proj_out) quantized with per-K (input channel)
    scales where per-N ones belong; → the sites changed."""
    from psd_tpu_torch.ops.quant import quant_cols

    n = 0
    for prefix, m in unet.named_modules():
        for name in getattr(m, "int8_sites", ()):
            wq = getattr(m, f"{name}_wq")
            if wq.ndim != 2 or wq.shape[0] != wq.shape[1]:
                continue
            q, sw = quant_cols(fp32[f"{prefix}.{name}.weight"].reshape(wq.shape), axis=1)
            wq.copy_(q)
            getattr(m, f"{name}_sw").copy_(sw.reshape(-1))
            n += 1
    return n


def _spread_gains_(unet, fp32: dict, gen) -> dict:
    """fp32 weights of the same function with the int8 attention sites'
    channels spread: at each attention with int8 weights, q's output
    channels times g and k's (to_k, and to_k_dis of split3) times 1/g, v's
    (to_v, to_v_dis) times h and to_out_0's input channels times 1/h, g and
    h 2^u with u ~ U(-VAE_GAIN_LOG2, VAE_GAIN_LOG2): the logits and the
    output are unchanged up to rounding. Flax-style init gives every output
    channel the same range, where per-N and per-K scales read alike; trained
    weights' channels spread (as phase 5b spreads the VAE's)."""
    out = dict(fp32)

    def gains(n):
        return torch.exp2((2.0 * torch.rand(n, generator=gen, device=gen.device) - 1.0)
                          * VAE_GAIN_LOG2)

    for prefix, m in unet.named_modules():
        if "to_q" not in getattr(m, "int8_sites", ()):
            continue
        g, h = gains(m.to_q.out_features), gains(m.to_v.out_features)
        for name, row_gain in (("to_q", g), ("to_k", 1.0 / g), ("to_k_dis", 1.0 / g),
                               ("to_v", h), ("to_v_dis", h)):
            key = f"{prefix}.{name}.weight"
            if key in out:
                out[key] = fp32[key] * row_gain[:, None]
        key = f"{prefix}.to_out_0.weight"
        out[key] = fp32[key] / h[None, :]
    return out


def _lever_eps(card: str) -> dict:
    """One SD-scale eps (phase 4's inputs and weights) per lever: ToMe 0.5
    in branch and in block mode, and the int8 UNet, on the kernels against
    all plain, their launches against the routes'; the int8 eps against the
    bf16 eps of the same weights (its attention sites' channels spread,
    _spread_gains_), and a planted fault's (_per_k_int8_)."""
    from dataclasses import replace

    from psd_tpu_torch.core.mode import KERNELS, disable_kernels
    from psd_tpu_torch.diffusion.dadd import DADDCoreConfig
    from psd_tpu_torch.models.init import flax_init_
    from psd_tpu_torch.models.layers import quantize_int8_weights_, store_weights_in_
    from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.testing import route_launches

    dev = torch.device("cuda")
    cfg = sd14_unet_config(attn_mode="split3", gate_init_anatomy=(0.1, 0.9),
                           gate_init_disease=(0.9, 0.1), dtype=torch.bfloat16)

    def built(ucfg, weights):
        with dev:
            unet = UNet2DCondition(ucfg).eval()
        unet.load_state_dict(weights)
        quantize_int8_weights_(unet)
        return store_weights_in_(unet, torch.bfloat16)

    with dev:
        plain = UNet2DCondition(cfg).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    flax_init_(plain, g)
    x = torch.randn((8, 64, 64, 4), generator=g, device=dev)
    t = torch.full((8,), 501, dtype=torch.int32, device=dev)
    ctx = torch.randn((8, 48, 768), generator=g, device=dev)
    fp32 = {k: v.clone() for k, v in plain.state_dict().items()}
    store_weights_in_(plain, torch.bfloat16)
    models = {}
    for name, kw in (("tome_branch", dict(tome_ratio=0.5, tome_mode="branch")),
                     ("tome_block", dict(tome_ratio=0.5, tome_mode="block"))):
        with torch.device("meta"):  # ToMe adds no parameter: the plain model's tensors, shared
            unet = UNet2DCondition(replace(cfg, **kw)).eval()
        unet.load_state_dict(plain.state_dict(), assign=True)
        models[name] = unet.config, unet, plain
    q8cfg = replace(cfg, quant="int8")
    with dev:
        sites = UNet2DCondition(q8cfg)
    spread = _spread_gains_(sites, fp32, torch.Generator(device=dev).manual_seed(5))
    del sites
    models["int8"] = q8cfg, built(q8cfg, spread), built(cfg, spread)
    out = {}
    with torch.inference_mode():
        for name, (lcfg, unet, ref) in models.items():
            eps_ref = ref(x, t, ctx, 1.0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            eps_k = unet(x, t, ctx, 1.0)
            torch.cuda.synchronize()
            counts = {k: kernels.launch_counts[k] for k in SERVE_KERNELS}
            want = route_launches(DADDCoreConfig(unet=lcfg), VAEConfig(), 8, 512, 1, decode=False)
            with disable_kernels(*KERNELS):
                eps_p = unet(x, t, ctx, 1.0)
            rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
            ref_rel = ((eps_k - eps_ref).norm() / eps_ref.norm()).item()
            ms = time_ms(lambda: unet(x, t, ctx, 1.0), n=3, warmup=1)
            ref_ms = time_ms(lambda: ref(x, t, ctx, 1.0), n=3, warmup=1)
            dev_ms = _eps_device_ms(lambda: unet(x, t, ctx, 1.0), ())
            ref_dev_ms = _eps_device_ms(lambda: ref(x, t, ctx, 1.0), ())
            r = {"rel_l2_vs_plain": rel, "rel_l2_vs_exact": ref_rel, "launches": counts,
                 "routes": want, "ms": ms, "exact_ms": ref_ms, "device_ms": dev_ms,
                 "exact_device_ms": ref_dev_ms}
            if name == "int8":
                r["fault_sites"] = _per_k_int8_(unet, spread)
                fault = unet(x, t, ctx, 1.0)
                r["fault_rel_l2_vs_exact"] = ((fault - eps_ref).norm() / eps_ref.norm()).item()
                del fault
            out[name] = r
            log(f"[levers] eps {name} (8,64,64,4), 48 tokens, delta 1.0: rel L2 kernels vs plain "
                f"{rel:.3e} (band {UNET_REL_BAND:g}), vs the exact eps of the same weights "
                f"{ref_rel:.3e}"
                + (f" (attention channels spread by 2^±{VAE_GAIN_LOG2:g}), the planted fault "
                   f"(per-K scales at {r['fault_sites']} square projections) "
                   f"{r['fault_rel_l2_vs_exact']:.3e}" if name == "int8" else "")
                + f"; launches {counts}, the routes' {want}; eps {ms:.2f} ms, the exact eps "
                f"{ref_ms:.2f} ms (eager, host clock); on the device (one eps captured, "
                f"replayed) {dev_ms} ms, the exact eps {ref_dev_ms} ms; on {card}")
            del eps_k, eps_p, eps_ref
    del models, unet, ref, plain, fp32, spread
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_unet_levers(card: str, turbo: dict, results: dict) -> dict:
    """The UNet's inference levers at full width (phase 5e): the kernels at
    the shapes ToMe gives them; one eps per lever (ToMe branch and block,
    the int8 UNet) against all plain, the int8 one against the bf16 eps;
    the README's turbo point with ToMe (TOME_TURBO) served by graph replay
    against its eager run; the infer CLI with the README's turbo flags."""
    import numpy as np
    from PIL import Image

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.diffusion.dadd import DADD, core_config_from
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines.serve import GenerationServer
    from psd_tpu_torch.testing import route_launches

    _lever_kernels(results)
    eps = _lever_eps(card)

    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    size, batch = cfg.dataset.image_size, 8
    core_cfg = core_config_from(cfg, tome_ratio=TOME_TURBO["tome_ratio"],
                                tome_mode=TOME_TURBO["tome_mode"])
    vae_cfg = VAEConfig(quant=TOME_TURBO["vae_quant"])
    t0 = time.perf_counter()
    model = DADD(cfg, core_cfg=core_cfg, vae_cfg=vae_cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((batch, 257, 1024)).astype(np.float32)
    targets = np.linspace(0.0, 3.0, batch)
    requests = [(feats[i], targets[i], 1.0, i) for i in range(batch)]

    def make_server():
        return GenerationServer(model, image_size=size, sampling_steps=TOME_TURBO["steps"],
                                steer_scale=1.0, max_batch=batch, max_wait_s=0.05,
                                encoder_stride=TOME_TURBO["encoder_stride"],
                                cache_mode=TOME_TURBO["cache_mode"],
                                sampler=TOME_TURBO["sampler"])

    server = make_server()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    images, wall_first = _serve(server, requests)
    counts = dict(kernels.launch_counts)
    dims = dict(kernels.attention_head_dims)
    peak = torch.cuda.max_memory_allocated() / 2**30
    (prog,) = _programs(model, "generate")
    launches = dict(prog.launches)
    again, wall_replay = _serve(server, requests)
    _close(server, "ToMe turbo graph")
    with eager():
        eserver = make_server()
    eager_images, wall_eager = _serve(eserver, requests)
    _close(eserver, "ToMe turbo eager")
    replay_ms = _replay_ms(prog)
    expected = route_launches(core_cfg, vae_cfg, batch, size, TURBO_FULL, TURBO_SHALLOW)
    diffs = {"replay vs eager": _max_diff(images, eager_images),
             "replay again": _max_diff(again, images)}
    del server, eserver, prog
    model.programs.clear()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    work = ROOT / "build" / "psd_tpu_torch" / "infer"
    work.mkdir(parents=True, exist_ok=True)
    structure = work / "structure.png"
    if not structure.exists():
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (512, 512, 3), np.uint8)).save(
            structure)
    cli = _infer_run("turbo", INFER_TURBO, work / "turbo", card, structure)
    cli.pop("out")
    gc.collect()
    torch.cuda.empty_cache()

    int8 = eps["int8"]
    checks = {
        "images (512,512,3) finite in [0,1]": all(
            im.shape == (size, size, 3) and np.isfinite(im).all() and im.min() >= 0.0
            and im.max() <= 1.0 for im in images),
        "targets differ": not np.allclose(images[0], images[-1], atol=1e-3),
        f"the capture launches the routes' {expected}": launches == expected,
        "every image equals the eager run's": max(diffs.values()) == 0.0,
        **{f"eps {k} kernels vs plain rel L2 <= {UNET_REL_BAND:g}":
           eps[k]["rel_l2_vs_plain"] <= UNET_REL_BAND for k in ("tome_branch", "tome_block",
                                                                 "int8")},
        **{f"eps {k} launches the routes'": eps[k]["launches"] == eps[k]["routes"]
           for k in ("tome_branch", "tome_block", "int8")},
        f"int8 eps vs bf16 rel L2 <= {LEVER_INT8_BAND:g}":
            int8["rel_l2_vs_exact"] <= LEVER_INT8_BAND,
        f"the planted fault beyond {LEVER_INT8_BAND:g}":
            int8["fault_rel_l2_vs_exact"] > LEVER_INT8_BAND,
        **{f"infer turbo {k}": v for k, v in cli["checks"].items()},
    }
    log(f"[levers] {batch} requests, {size}px, {TOME_TURBO}, by graph replay: model built in "
        f"{build_s:.1f} s; first batch (warm-up + capture + replay) wall {wall_first:.3f} s; a "
        f"replayed batch wall {wall_replay:.3f} s ({batch / wall_replay:.4f} img/s), eager "
        f"{wall_eager:.3f} s; peak allocated over the first batch {peak:.3f} GiB; on {card}")
    log(f"[levers] one replay: device ms {replay_ms['device_ms']:.2f}, host ms until replay() "
        f"returns {replay_ms['host_launch_ms']:.2f}; phase 5b's turbo replay (no ToMe) in this "
        f"call: device ms {turbo['replay_ms']['device_ms']:.2f}, host ms "
        f"{turbo['replay_ms']['host_launch_ms']:.2f} (a record, not a claim)")
    log(f"[levers] host launch counts over the first batch {counts}; one replay launches "
        f"{launches}; attention by head dim {dims}; max abs difference {diffs}")
    log(f"[levers] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: lever checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    total = {k: counts.get(k, 0) + cli["counts"].get(k, 0) for k in set(counts) | set(cli["counts"])}
    head_dims = {d: dims.get(d, 0) + cli["head_dims"].get(d, 0)
                 for d in set(dims) | set(cli["head_dims"])}
    return {"counts": total, "head_dims": head_dims, "replay_launches": launches,
            "replay_ms": replay_ms, "wall_s": wall_replay, "eps": eps, "diffs": diffs,
            "infer": cli, "peak_gib": peak}


def _attention_bwd_reading(shape, q, k, v, dout) -> dict:
    """The attention backward at one shape: judged against autograd through
    the plain forward (`_check_attention_bwd`), timed beside the plain
    version, SDPA's backward alone (the library call) and both fwd+bwd, with
    its bound. → the shape's entry."""
    from psd_tpu_torch.ops import attention

    B, S, H, D = shape
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
    return {"shape": list(shape), "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "library_ms": ms_l, "fwd_bwd_ms": ms_fb, "sdpa_fwd_bwd_ms": ms_lfb,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes, **readings}


def _check_split3_autograd(randn, shape, timed: bool = True) -> None:
    """split3's autograd.Function (kernel forward, plain backward) against
    autograd through the plain version at `shape`, δ = 1; timed beside."""
    from psd_tpu_torch.ops import split3

    B, S, H, D = shape
    ins = [randn(B, S, H, D)] + [randn(B, 16, H, D) for _ in range(6)]
    dout = randn(B, S, H, D)
    d1 = _delta(1.0)

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*xs, d1, 0.1, 0.9, None)
        return (out.detach(),) + torch.autograd.grad(out, xs, dout)

    got = grads(split3.Split3Attention.apply)
    want = grads(split3.split3_reference)
    _grad_compare("split3 autograd.Function", (B, S, H, D),
                  ("out", "dq", "dk_anat", "dv_anat", "dk_dis", "dv_dis", "dk_delta",
                   "dv_delta"), got, want)
    if timed:
        ms_k = time_ms(lambda: grads(split3.Split3Attention.apply), n=5)
        ms_p = time_ms(lambda: grads(split3.split3_reference), n=5)
        log(f"[train] split3 fwd+bwd {(B, S, H, D)}: kernel forward + plain backward "
            f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")


def phase_train_kernels(results: dict) -> None:
    """The attention backward kernel and split3's autograd.Function at the
    training shapes, against autograd through their plain versions; the
    backward also at its edge shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape in ATTN_BWD_SHAPES:
        q, k, v, dout = (randn(*shape) for _ in range(4))
        entry = _attention_bwd_reading(shape, q, k, v, dout)
        r = results.setdefault("attention_bwd", {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                                 "library_ms": 0.0, "bound_ms": 0.0,
                                                 "fwd_bwd_ms": 0.0, "sdpa_fwd_bwd_ms": 0.0,
                                                 "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], entry["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "fwd_bwd_ms", "sdpa_fwd_bwd_ms"):
            r[key] += entry[key]
        r["shapes"].append(entry)
        del q, k, v, dout
        torch.cuda.empty_cache()

    # the narrow forward's edge shapes: every padded head dim the backward is
    # built for too, one or three heads, Sq != Sk (not timed)
    for (B, Sq, H, D), Sk in ATTN_NARROW_EDGE_SHAPES:
        q, dout = randn(B, Sq, H, D), randn(B, Sq, H, D)
        k, v = randn(B, Sk, H, D), randn(B, Sk, H, D)
        _check_attention_bwd(q, k, v, dout, f"edge {(B, Sq, H, D)} Sk {Sk} (not timed)")

    for shape in SPLIT3_TRAIN_SHAPES:
        _check_split3_autograd(randn, shape)


def _state_tensors(state) -> dict:
    """Everything a train step writes, by name: each parameter, its AdamW
    moments and step count, its EMA, its accumulated gradient."""
    named = dict(state.model.core.named_parameters())
    out = {}
    for n, p in named.items():
        out[f"param {n}"] = p.detach()
        out[f"ema {n}"] = state.ema.params[n]
        for k, t in (state.opt_state.adamw.state.get(p) or {}).items():
            out[f"{k} {n}"] = t
    for n, a in zip(named, state.opt_state.acc or []):
        out[f"acc {n}"] = a
    return out


def _states_differ(a, b) -> list:
    """What differs between two train states, bit for bit: tensor names
    (with the largest absolute difference) and counts; [] when equal."""
    ta, tb = _state_tensors(a), _state_tensors(b)
    if ta.keys() != tb.keys():
        return [f"tensors {sorted(ta.keys() ^ tb.keys())[:4]}"]
    bad = [f"{k} ({(ta[k].double() - tb[k].double()).abs().max().item():.3e})"
           for k in ta if not torch.equal(ta[k], tb[k])]
    oa, ob = a.opt_state, b.opt_state
    for what, x, y in (("step", a.step, b.step), ("count", oa.count, ob.count),
                       ("mini_step", oa.mini_step, ob.mini_step),
                       ("ema count", a.ema.count, b.ema.count)):
        if x != y:
            bad.append(f"{what} {x} != {y}")
    return bad


def _stepped(step, state, batch, counts: Counter, dims: Counter):
    """One synced call of a train step, with the launch counts set to 0
    just before it; its launches (host counts) and attention's by head dim
    added to `counts` and `dims`; → (state, metrics, seconds)."""
    from psd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts.update(kernels.launch_counts)  # every kernel's, 0 where not launched
    dims.update({k: n for k, n in kernels.attention_head_dims.items() if n})
    return state, metrics, dt


def _device_busy(fn) -> tuple:
    """fn() once under torch.profiler's CUDA activity, synced: the device's
    busy time (ms, the union of its activities' intervals: kernels, copies,
    fills), its activities and the wall (ms). The raw events are read, not
    torch's per-op tables, whose build takes a minute at 150k kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def _pool_gib(pool):
    """The bytes the allocator holds in graph pool `pool`, GiB (None where
    its snapshot names no pools)."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 2**30


def _train_programs(state) -> list:
    return [p for key, p in state.programs.items() if key[0] == "train_step"]


def phase_train(card: str) -> dict:
    """The SD-scale train step: 5 eager steps and the same 5 by replay of a
    captured program, bit for bit; kernels vs plain on one loss + backward;
    the accumulating step's two programs against eager."""
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import TRAINING_KERNELS, disable_kernels, training_mode
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.train import (build_optimizer, compile_train_step, create_train_state,
                                     ema_apply_, ema_flags, make_train_step)

    cfg = load_config(ROOT / "configs" / "train_ip.yaml", TRAIN_ARGS)
    size, B = cfg.dataset.image_size, TRAIN_BATCH
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0, for_training=True)
    state, tx = create_train_state(model, steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    step = make_train_step(model, tx)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.core.parameters())
    log(f"[train] SD-scale DADD core for training ({n_params:,} fp32 parameters, remat "
        f"{model.core_cfg.unet.remat}) and its optimizer built in {time.perf_counter() - t0:.1f} s")
    assert all(p.dtype == torch.float32 for p in model.core.parameters())
    # the replayed run's model: the same initial weights, a state of its own
    graph_model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=None, for_training=True)
    graph_model.core.load_state_dict(model.core.state_dict())
    graph_state, graph_tx = create_train_state(graph_model, steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    graph_step = compile_train_step(graph_model, graph_tx)
    diff0 = _states_differ(state, graph_state)
    if diff0:
        raise SystemExit(f"chip_smoke.py: the two train states differ before a step: {diff0[:4]}")

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

    # eager step i, then replayed step i, on the same draws (each state's
    # generator, seeded alike); the first compiled call warms up and captures
    torch.cuda.reset_peak_memory_stats()
    counts, dims, graph_counts, graph_dims = Counter(), Counter(), Counter(), Counter()
    times, graph_times, losses, norms, mismatches, lrs = [], [], [], [], {}, []
    reserved0 = torch.cuda.memory_reserved()
    for i in range(TRAIN_STEPS):
        state, metrics, dt = _stepped(step, state, batch, counts, dims)
        graph_state, graph_metrics, dt_g = _stepped(graph_step, graph_state, batch,
                                                    graph_counts, graph_dims)
        times.append(dt)
        graph_times.append(dt_g)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        bad = [k for k in metrics if not torch.equal(metrics[k], graph_metrics[k])]
        lrs.append([float(g_["lr"]) for g_ in graph_state.opt_state.adamw.param_groups])
        if i >= TRAIN_STEPS - 2:  # after the blend, and after epoch 1's LR
            bad += _states_differ(state, graph_state)
        if bad:
            mismatches[i] = bad[:6] + ([f"... {len(bad) - 6} more"] if len(bad) > 6 else [])
        if i == 0:
            pool_gib = _pool_gib(graph_state.pool)
            grown_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30
    counts, dims = dict(counts), dict(dims)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    progs = _train_programs(graph_state)
    prog = progs[0] if len(progs) == 1 else None
    per_step = {k: v // TRAIN_STEPS for k, v in counts.items()}
    moved = {n: not torch.equal(w, dict(model.core.named_parameters())[n].detach())
             for n, w in watch.items()}
    ema_moved = {n: not torch.equal(ema0[n], state.ema.params[n]) for n in watch}
    tcfg = cfg.training
    ema_updates = sum(1 for i in range(TRAIN_STEPS) if i >= tcfg.update_starting_at_step and
                      (i - tcfg.update_starting_at_step) % tcfg.update_every_n_steps == 0)
    step_s = statistics.median(times[1:])
    graph_s = statistics.median(graph_times[1:])
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
        "launches the same each step": all(v % TRAIN_STEPS == 0 for v in counts.values()),
        "replayed steps bit-equal to eager (metrics; all state after steps 4, 5)":
            not mismatches,
        "one program, 4 replays": prog is not None and prog.replays == TRAIN_STEPS - 1,
        "LR changed between two replays (epoch 1)": lrs[-1] != lrs[-2]
            and lrs[-2] == lrs[0],
        "the program launches a step's kernels": prog is not None and {
            k: n for k, n in prog.launches.items() if n} == {
            k: n for k, n in per_step.items() if n},
        "host launches: the warm-up and the capture, none at replay": {
            k: n for k, n in graph_counts.items() if n} == {
            k: 2 * n for k, n in per_step.items() if n},
    }
    log(f"[train] {TRAIN_STEPS} eager steps at {size}², batch {B}: losses {losses}, grad norms "
        f"{norms}; step times {[round(t, 4) for t in times]} s; steady step {step_s:.4f} s = "
        f"{B / step_s:.2f} img/s on {card}")
    log(f"[train] the same {TRAIN_STEPS} steps by compile_train_step: call times "
        f"{[round(t, 4) for t in graph_times]} s (the first: warm-up step + capture); steady "
        f"replayed step {graph_s:.4f} s = {B / graph_s:.2f} img/s ({step_s / graph_s:.3f}x the "
        f"eager step) on {card}; LRs by step {lrs}; mismatches {mismatches or 'none'}")
    if prog is not None:
        log(f"[train] program: warm-up {prog.warmup_s:.3f} s, capture {prog.capture_s:.3f} s, "
            f"instantiation {prog.instantiate_s:.3f} s; launches a replay "
            f"{dict(prog.launches)} against the eager per-step {per_step}; graph pool "
            + (f"{pool_gib:.3f} GiB" if pool_gib is not None else "not measured")
            + f" (reserved memory grew {grown_gib:.3f} GiB over the first call, AdamW's "
            f"moments of {2 * n_params * 4 / 2**30:.3f} GiB among it); peak allocated "
            f"{peak_gb:.2f} GiB (both models)")
    log(f"[train] launches over {TRAIN_STEPS} eager steps {counts}; attention by head dim {dims}; "
        f"the compiled run's host launches {dict(graph_counts)}")

    # one more step of each under the profiler: the device's busy share
    eager_busy = _device_busy(lambda: step(state, batch))
    graph_busy = _device_busy(lambda: graph_step(graph_state, batch))
    for label, (busy, n_act, wall) in (("eager", eager_busy), ("replayed", graph_busy)):
        log(f"[train] one {label} step under torch.profiler: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms over {n_act} activities, idle share {max(0.0, 1 - busy / wall):.4f} "
            f"on {card}")
    # the EMA's update alone, the work every step does: three passes over
    # the 920 M entries, against one read of the average and the parameters
    # and one write of the average; at a blend and at a step the gate skips
    # (the same work: the select form), and what that costs over the
    # configs' schedule (start 100, every 4) where the host branch did
    # nothing at a skipped step
    named_g = dict(graph_model.core.named_parameters())
    ema_ms, ema_off_ms = (
        time_ms(lambda: ema_apply_(graph_state.ema, named_g, *flags, decay=tcfg.ema_decay),
                n=5, warmup=1)
        for flags in (ema_flags(graph_state.ema, True, dev),
                      ema_flags(graph_state.ema, False, dev)))
    entry_gb = n_params * 4 / 1e9
    skipped_1k = sum(1 for i in range(1000) if not (i >= 100 and (i - 100) % 4 == 0))
    log(f"[train] the EMA's update alone: a blend {ema_ms:.3f} ms, a skipped step "
        f"{ema_off_ms:.3f} ms (CUDA events, median of 5) of the {graph_s * 1e3:.1f} ms replayed "
        f"step; its three passes move {7 * entry_gb:.2f} GB ({7 * entry_gb / 3.35:.3f} ms at "
        f"3.35 TB/s), a select's one read and write {3 * entry_gb:.2f} GB "
        f"({3 * entry_gb / 3.35:.3f} ms); over the configs' first 1000 steps (start 100, every "
        f"4) {skipped_1k} skipped steps pay {skipped_1k * ema_off_ms / 1e3:.3f} s "
        f"({ema_off_ms / (graph_s * 1e3):.4f} of a replayed step each) on {card}")
    log(f"[train] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: train checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    graph_state.drop_programs()
    del graph_state, graph_step, graph_tx, prog, progs
    gc.collect()
    torch.cuda.empty_cache()

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

    # accumulation: 2 micro-steps an optimizer step, batch 8, both models
    # from the eager model's weights; two programs on one graph pool
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    _check_accumulation_shapes()
    graph_model.core.load_state_dict(model.core.state_dict())
    acfg = load_config(ROOT / "configs" / "train_ip.yaml",
                       TRAIN_ARGS + ["training.accumulate_grad_batches=2"])
    small = {k: v[:ACCUM_BATCH] for k, v in batch.items()}
    runs = []
    for m, compiled in ((model, False), (graph_model, True)):
        atx = build_optimizer(acfg, TRAIN_STEPS_PER_EPOCH)
        st, atx = create_train_state(m, tx=atx)
        runs.append([st, (compile_train_step if compiled else make_train_step)(m, atx), []])
    acc_counts = Counter()
    for i in range(ACCUM_STEPS):
        for r, c in zip(runs, (Counter(), acc_counts)):
            r[0], m_, _ = _stepped(r[1], r[0], small, c, Counter())
            r[2].append(m_)
    (st_e, _, m_e), (st_g, step_g, m_g) = runs
    acc_bad = [f"step {i} {k}" for i in range(ACCUM_STEPS) for k in m_e[i]
               if not torch.equal(m_e[i][k], m_g[i][k])] + _states_differ(st_e, st_g)
    aprogs = _train_programs(st_g)
    acc_checks = {
        "bit-equal to eager (metrics, all state)": not acc_bad,
        "two programs (micro-step, applying step), one pool": len(aprogs) == 2
            and st_g.pool is not None,
        "each replayed once": sorted(p.replays for p in aprogs) == [1, 1],
        "each launches a step's kernels": all({k: n for k, n in p.launches.items() if n} == {
            k: n for k, n in per_step.items() if n} for p in aprogs),
        "2 optimizer steps, mini_step 0": (st_g.opt_state.count, st_g.opt_state.mini_step) == (
            2, 0),
    }
    log(f"[train] accumulation (2 micro-steps a step, batch {ACCUM_BATCH}, {ACCUM_STEPS} steps): "
        f"losses {[float(m_['loss']) for m_ in m_g]}; graph pool "
        + (f"{_pool_gib(st_g.pool):.3f} GiB" if _pool_gib(st_g.pool) is not None
           else "not measured")
        + f"; mismatches {acc_bad[:6] or 'none'}; checks {acc_checks}")
    if not all(acc_checks.values()):
        raise SystemExit(f"chip_smoke.py: accumulation checks failed: "
                         f"{[k for k, v in acc_checks.items() if not v]}")
    graph_counts.update(acc_counts)
    del runs, st_e, st_g, step_g, aprogs, model, graph_model
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "head_dims": dims, "step_s": step_s, "img_per_s": B / step_s,
            "graph_step_s": graph_s, "graph_img_per_s": B / graph_s, "peak_gb": peak_gb,
            "ema_ms": ema_ms, "ema_off_ms": ema_off_ms,
            "graph_counts": dict(graph_counts), "graph_head_dims": dict(graph_dims),
            "rel_loss": rel_loss, "rel_grad": rel_grad, "rel_attn1_leaf": rel_leaf}


def _check_accumulation_shapes() -> None:
    """The training kernels at the accumulation check's batch-8 shapes
    against their plain versions (not timed): the attention forward, its
    backward, split3's autograd.Function."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    _judge_shapes("train accumulation", [(ACCUM_BATCH, 1024, 8, 40)], [], [], seed=6)
    shape = (ACCUM_BATCH, 1024, 8, 40)
    q, k, v, dout = (randn(*shape) for _ in range(4))
    _check_attention_bwd(q, k, v, dout, f"accumulation {shape} (not timed)")
    for shape in [(ACCUM_BATCH, 1024, 8, 40), (ACCUM_BATCH, 256, 8, 80)]:
        _check_split3_autograd(randn, shape, timed=False)


# ---- train CLI -----------------------------------------------------------------
def _write_tree(root: Path, images=TRAIN_CLI_IMAGES) -> None:
    """The seeded synthetic tree: smooth random RGB PNGs of TRAIN_CLI_HW,
    `images[split]` a split, evenly over four class directories."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    H, W = TRAIN_CLI_HW
    for split, n in images.items():
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
    d0 = _delta(0.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in TRAIN_CLI_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, d0, 0.1, 0.9),
            split3.split3_reference(q, *banks, d0, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[train_cli] {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C in TRAIN_CLI_LN_SHAPES:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in TRAIN_CLI_GN_SHAPES:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def _full_shallow(steps: int, stride: int, cache_mode: str = "deep") -> tuple:
    """(full, shallow) UNet evaluations of `steps` sampler steps under
    feature propagation at `stride`: DeepCache's key steps
    (`sampler.key_step_count`) full, the rest shallow. route_launches
    models DeepCache's shallow steps alone, not encoder propagation's."""
    full = key_step_count(steps, stride)
    if full < steps and cache_mode != "deep":
        raise SystemExit(f"chip_smoke.py: route_launches counts DeepCache's shallow steps only, "
                         f"not {cache_mode!r}'s")
    return full, steps - full


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
    and phase 6's per step. Its tree and checkpoints stay for the product-loop
    phase, which deletes them."""
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
    replays1 = [p.replays for p in _train_programs(state)]
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
    replays2 = [p.replays for p in _train_programs(r2["state"])]
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

    # the CLI's step is compile_train_step: the first step's warm-up and
    # capture each launch a step's kernels on the host, a replay none; so
    # run 1's two steps launch two steps' worth, and so does run 2's one
    want1 = expect(steps=(per_step, 2), encodes=(enc, 3), val=(val_fwd, 1), grid=(grid, 1))
    want2 = expect(steps=(per_step, 2), encodes=(enc, 1))
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
        "one train program a run; run 1's step 2 a replay, run 2's step its warm-up":
            (replays1, replays2) == ([1], [0]),
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

    log(f"[train_cli] run 1 ({B} PNGs a batch at {size}², 2 steps by compile_train_step: the "
        f"first a warm-up step and the capture, the second a replay): main() wall "
        f"{wall1:.3f} s with the model's build; phases as the CLI times them (no sync: host "
        f"time), each call: {laps_text(laps1)}; steady "
        f"{steady:.2f} img/s (the logged step 2) against phase 6's replayed "
        f"{trained['graph_img_per_s']:.2f} and eager {trained['img_per_s']:.2f} img/s; peak "
        f"allocated {peak1:.2f} GiB; on {card}")
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
    _check_train_cli_shapes()
    log(f"[train_cli] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: train CLI checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    counts = {k: counts1[k] + counts2[k] + counts3[k] for k in counts1}
    head_dims = {d: dims1.get(d, 0) + dims2.get(d, 0) + dims3.get(d, 0)
                 for d in set(dims1) | set(dims2) | set(dims3)}
    return {"counts": counts, "head_dims": head_dims, "img_per_s": steady,
            "saves": [save1, save2], "restore": (restored["bytes"], restored["seconds"]),
            "work": work}


def _check_loop_shapes() -> None:
    """Each kernel of the product loop's generate against its plain version
    by its judge at LOOP_* (batch 12 at 256²; not timed, not counted)."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    checks = []
    for shape in LOOP_ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        checks.append(("attention", shape, attention_judge(
            attention.attention_fwd(q, k, v), attention.attention_reference(q, k, v))))
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in LOOP_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
            split3.split3_reference(q, *banks, d1, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[loop] {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C in LOOP_LN_SHAPES:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in LOOP_GN_SHAPES:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def _backbone_features(bank, images, faults=()) -> dict:
    """The FeatureBank's three features of `images`, with the planted
    `faults` ("pool_pad": Inception's branch pools counting the padding;
    "no_antialias": VGG's 256² → 224² shrink without antialiasing; "bgr":
    CLIP given the images' channels reversed; "round_bytes": the CLIP
    processor's bytes rounded, not truncated)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch.nn.functional as F

    from psd_tpu_torch.data import preprocess
    from psd_tpu_torch.models import inception
    from psd_tpu_torch.pipelines import evaluate

    with contextlib.ExitStack() as stack:
        if "pool_pad" in faults:
            stack.enter_context(mock.patch.object(
                inception, "_avg_pool_3x3_same",
                lambda x: F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)))
        if "no_antialias" in faults:
            def plain(x, h, w):
                y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                                  align_corners=False)
                return y.permute(0, 2, 3, 1).to(x.dtype)
            stack.enter_context(mock.patch.object(evaluate, "resize_bilinear", plain))
        if "round_bytes" in faults:
            def rounded(image):
                image = np.asarray(image)
                return np.rint(image.astype(np.float64) * 255).astype(np.uint8), True
            stack.enter_context(mock.patch.object(preprocess, "processor_uint8", rounded))
        return {"inception": bank.inception(images), "vgg": bank.vgg(images),
                "clip": bank.clip(images[..., ::-1] if "bgr" in faults else images)}


def _cpu_backbone_features(bank, images) -> dict:
    """The same three features from the same fp32 weights on the CPU, in
    fp32 (the reference the card's bf16 features are held to)."""
    import dataclasses

    import numpy as np

    from psd_tpu_torch.data.preprocess import clip_preprocess_float
    from psd_tpu_torch.metrics.cmmd import l2_normalize
    from psd_tpu_torch.models.clip import CLIPVisionTower
    from psd_tpu_torch.models.inception import InceptionV3Features, inception_preprocess
    from psd_tpu_torch.models.resize import resize_bilinear
    from psd_tpu_torch.models.vgg import VGG16Features, imagenet_normalize

    x = torch.as_tensor(np.asarray(images), dtype=torch.float32)
    out = {}
    with torch.inference_mode():
        for name, cls in (("inception", InceptionV3Features), ("vgg", VGG16Features)):
            net = cls(torch.float32).eval()
            net.load_state_dict({k: v.cpu() for k, v in bank._nets[name].state_dict().items()})
            out[name] = (net(inception_preprocess(x)) if name == "inception" else
                         net(imagenet_normalize(resize_bilinear(x, 224, 224))))
        model = bank.model
        tower = CLIPVisionTower(dataclasses.replace(model.clip_cfg, dtype=torch.float32)).eval()
        tower.load_state_dict({k: v.cpu() for k, v in model.clip.state_dict().items()})
        pre = np.stack([clip_preprocess_float(im, model.clip_cfg.image_size) for im in images])
        out["clip"] = l2_normalize(tower.image_embeds(torch.from_numpy(pre)).float())
    return out


def phase_product_loop(card: str, cli: dict) -> dict:
    """psd_tpu's product loop (tests/test_product_loop.py) on the card at
    full width, on phase 6b's checkpoint and PNG tree: the augment factory
    (python -m psd_tpu_torch.pipelines.augment, in-process) writes the
    synthetic train split; the evaluation sweep scores two scales on the
    val split; the classifier trains on the synthetic-only split and is
    judged on the real val images. Each generate's launches against the
    routes' at batch 12; the first replayed augment batch against an eager
    generate of its inputs, bit for bit; the backbones' bf16 features
    against fp32 on the CPU (CLIP's band proves the plumbing only: bytes
    rounded instead of truncated read inside it); the CLIP processor's
    bytes of these images against transformers' truncation, byte for byte;
    the files against the classifier dataset's filter."""
    import shutil
    from statistics import median
    from unittest import mock

    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.data.classification import MESClassificationDataset
    from psd_tpu_torch.data.preprocess import processor_uint8
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.pipelines import augment, classify, evaluate
    from psd_tpu_torch.testing import route_launches

    work = cli["work"]
    data, ckpts = work / "data", work / "run" / "checkpoints"
    for step in sorted(p.name for p in ckpts.iterdir())[:-1]:
        shutil.rmtree(ckpts / step)  # the newest alone, for disk
    synth, cfg_path = work / "synthetic", ROOT / "configs" / "train_ip.yaml"
    size = load_config(cfg_path).dataset.image_size
    n_train = {c.name: len(list(c.iterdir())) for c in sorted((data / "train").iterdir())}
    n_val = sum(1 for _ in (data / "val").glob("*/*.png"))

    # augment: record the first batch's inputs and output for the eager check
    first = {}
    generate = evaluate.DADD.generate

    def recording(model, cond, **kw):
        out = generate(model, cond, **kw)
        if not first:
            first.update(cond=cond.clone(), kw={k: (v.clone() if torch.is_tensor(v) else v)
                                                for k, v in kw.items()}, out=out.clone())
        return out

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(evaluate.DADD, "generate", recording):
        aug, counts_a, dims_a, wall_a = _counted(augment.main, [
            "--config", str(cfg_path), "--checkpoint", str(ckpts), "--data-dir", str(data),
            "--output-dir", str(synth), *LOOP_AUGMENT])
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    model = aug["model"]
    progs = list(model.programs.values())
    with eager():
        again = model.generate(first["cond"], **first["kw"])
    replay_eq = bool(torch.equal(again, first["out"]))
    core_cfg, vae_cfg = model.core_cfg, model.vae_cfg
    per_batch = route_launches(core_cfg, vae_cfg, LOOP_BATCH, size, LOOP_STEPS)
    laps = aug["batch_seconds"]
    steady = sum(laps[1:]) / max(len(laps) - 1, 1)
    fakes = first["out"][:2].float().cpu().numpy()  # generated, float in [0, 1]
    del model, aug, again, progs[1:]
    prog = progs[0] if progs else None
    prog_info = (dict(warmup_s=prog.warmup_s, capture_s=prog.capture_s,
                      instantiate_s=prog.instantiate_s, launches=dict(prog.launches),
                      replays=prog.replays) if prog else None)
    del progs, prog
    first.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gen_files = sorted(synth.glob("train/*/generated_*.bmp"))
    idx_to_cls = sorted(n_train)
    want_per_cls = {c: sum(n_train.values()) - 1 - n_train[c] + (c == idx_to_cls[-1])
                    for c in idx_to_cls}
    got_per_cls = {c: len(list((synth / "train" / c).glob("generated_*.bmp"))) for c in idx_to_cls}

    # evaluate: the timer's phases, the model, and each checkpoint's pool when dropped
    timers, models, pools = [], [], []
    make_timer, model_for, drop = evaluate.PhaseTimer, evaluate.model_for, DADD.drop_programs

    def timer(device):
        timers.append(make_timer(device))
        return timers[-1]

    def building(*a):
        models.append(model_for(*a))
        return models[-1]

    def dropping(model):
        before = torch.cuda.memory_reserved()
        drop(model)
        pools.append((before - torch.cuda.memory_reserved()) / 2**30)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.multiple(evaluate, PhaseTimer=timer, model_for=building), \
            mock.patch.object(DADD, "drop_programs", dropping):
        results, counts_e, dims_e, wall_e = _counted(evaluate.main, [
            "--config", str(cfg_path), "--checkpoints", str(ckpts), "--data-dir", str(data),
            "--output-dir", str(work / "eval"), *LOOP_EVALUATE])
    peak_e = torch.cuda.max_memory_allocated() / 2**30
    laps_e = {k: [round(x, 4) for x in v] for k, v in timers[0].laps.items()}
    metrics_ok = all(np.isfinite(v) for r in results for v in
                     [*r.overall.values(), *(x for c in r.per_class.values() for x in c.values())])

    model = models[0]
    ds = evaluate.LIMUCDataset(data / "val", image_size=size, return_clip=True,
                               clip_size=model.clip_cfg.image_size, seed=0)
    jobs = evaluate.collect_jobs(ds, 4, 4)

    # the backbones' bf16 features on the card against fp32 on the CPU
    bank = evaluate.FeatureBank(model, allow_random_backbones=True)
    reals = [np.asarray(ds.load(i)["image"] + 1.0, np.float32) / 2.0 for i in (0, 8)]
    imgs = np.concatenate([np.stack(reals), fakes])
    on_card = _backbone_features(bank, imgs)
    ref = _cpu_backbone_features(bank, imgs)
    faulty = _backbone_features(bank, imgs, faults=("pool_pad", "no_antialias", "bgr"))
    rounded = _backbone_features(bank, imgs, faults=("round_bytes",))["clip"]

    def rel(a, b):
        return ((a.float().cpu() - b.float()).norm() / b.float().norm()).item()

    bands = {k: rel(on_card[k], ref[k]) for k in on_card}
    faults = {k: rel(faulty[k], ref[k]) for k in on_card}
    rounded_rel = rel(rounded, ref["clip"])
    # the CLIP processor's bytes, which CLIP's band cannot tell from rounded
    # ones: transformers' to_pil_image takes x·255 in float64, casts it to
    # float32 and truncates it to uint8
    truncated = [(im.astype(np.float64) * 255).astype(np.float32).astype(np.uint8)
                 for im in imgs]
    bytes_eq = all(np.array_equal(processor_uint8(im)[0], t) for im, t in zip(imgs, truncated))
    rounding_seen = any(not np.array_equal(np.rint(im.astype(np.float64) * 255).astype(np.uint8),
                                           t) for im, t in zip(imgs, truncated))
    del bank, model, models, on_card, faulty, rounded
    gc.collect()
    torch.cuda.empty_cache()

    # classify on the synthetic-only split, judged on the real val images
    step_s = []
    train_step = classify.train_step

    def timed_step(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = train_step(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return loss

    train_ds = MESClassificationDataset(synth, "train", 224)
    val_ds = MESClassificationDataset(synth, "val", 224)
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(classify, "train_step", timed_step):
        history, counts_c, _, wall_c = _counted(classify.main, [
            *LOOP_CLASSIFY, "--data-dir", str(synth), "--output-dir", str(work / "cls")])
    peak_c = torch.cuda.max_memory_allocated() / 2**30
    last = history[-1]
    cm = np.asarray(last["confusion_matrix"])
    steps_per_epoch = len(train_ds) // 32

    checks = {
        f"augment launches 2 x {per_batch} (warm-up and capture; replays none)":
            counts_a == {k: 2 * per_batch.get(k, 0) for k in counts_a},
        "augment: one program, its capture launching one batch's": prog_info is not None
            and prog_info["launches"] == {k: v for k, v in per_batch.items() if v},
        f"evaluate: {len(LOOP_SCALES)} scales replay one program, launching 2 x the batch's "
        f"(warm-up and capture; replays none)":
            counts_e == {k: 2 * per_batch.get(k, 0) for k in counts_e},
        "evaluate: the programs dropped once, after the checkpoint's last scale": len(pools) == 1,
        "classify launches none": sum(counts_c.values()) == 0,
        "first replayed augment batch equal to eager, bit for bit": replay_eq,
        f"generated {sum(want_per_cls.values())} BMPs under train/<class>/generated_*":
            len(gen_files) == sum(want_per_cls.values()) and got_per_cls == want_per_cls,
        "real train and val copied": len(list(synth.glob("train/*/im*.png"))) == sum(
            n_train.values()) and len(list(synth.glob("val/*/im*.png"))) == n_val,
        "synthetic-only train split, balanced": all("generated" in p.name for p, _ in
                                                    train_ds.samples)
            and len(set(train_ds.class_counts.tolist())) == 1
            and len(train_ds) == 4 * min(want_per_cls.values()),
        "val split real only": len(val_ds) == n_val and all(
            "generated" not in p.name for p, _ in val_ds.samples),
        "evaluate metrics finite, every class scored": metrics_ok and all(
            len(r.per_class) == 4 for r in results) and len(results) == len(LOOP_SCALES),
        f"classify: >= 2 optimizer steps an epoch ({steps_per_epoch}), 2 epochs": (
            steps_per_epoch >= 2 and len(history) == 2 and len(step_s) == 2 * steps_per_epoch),
        "classify metrics finite, losses finite": all(
            math.isfinite(h["qwk"]) and math.isfinite(h["train_loss"]) for h in history),
        f"confusion matrix sums to the {n_val} real val images": cm.shape == (4, 4)
            and int(cm.sum()) == n_val,
        "classifier checkpoints written": all((work / "cls" / f).exists() for f in
                                               ("last.npz", "best.npz",
                                                "best_confusion_matrix.json")),
    }
    for k, band in BACKBONE_REL_BANDS.items():
        checks[f"{k} bf16 card vs fp32 CPU rel L2 <= {band:g}"] = bands[k] <= band
        checks[f"{k} planted fault above its band"] = faults[k] > band
    checks["CLIP processor bytes truncated as transformers' (rounded ones differ)"] = (
        bytes_eq and rounding_seen)

    n_aug = sum(want_per_cls.values())
    log(f"[loop] augment (configs/train_ip.yaml at 256², batch {LOOP_BATCH}, {LOOP_STEPS} "
        f"steps, checkpoint EMA): {n_aug} images in {len(laps)} replays, main() wall "
        f"{wall_a:.3f} s with the model's build and the checkpoint's load; first batch "
        f"{laps[0]:.3f} s (warm-up + capture: {prog_info}), the rest {steady:.4f} s a batch "
        f"({LOOP_BATCH / steady:.2f} img/s, CLIP encode, conditioning and the host copy "
        f"included), end to end {n_aug / sum(laps):.2f} img/s; peak allocated {peak_a:.2f} "
        f"GiB; on {card}")
    log(f"[loop] evaluate ({len(LOOP_SCALES)} scales, {len(jobs)} jobs a scale, val split): "
        f"main() wall {wall_e:.3f} s; phases (synced) {laps_e}; the checkpoint's pool freed on "
        f"its drop after the last scale {[round(x, 3) for x in pools]} GiB; peak allocated "
        f"{peak_e:.2f} GiB; results "
        f"{[(r.scale, round(r.throughput_img_s, 2), r.overall) for r in results]}; on {card}")
    log(f"[loop] backbones bf16 (card) vs fp32 (CPU) rel L2 {bands}; planted faults "
        f"(Inception pools counting the padding, VGG's shrink without antialias, CLIP on BGR) "
        f"{faults}; CLIP on rounded processor bytes {rounded_rel:.4e}; bands "
        f"{BACKBONE_REL_BANDS}")
    log(f"[loop] classify (ResNet-18, 224², batch 32, {len(train_ds)} synthetic train images, "
        f"{n_val} real val): main() wall {wall_c:.3f} s; train_step median "
        f"{median(step_s) * 1e3:.2f} ms (first {step_s[0] * 1e3:.2f} ms, synced); epochs "
        f"{[(h['epoch'], round(h['train_loss'], 4), round(h['qwk'], 4), round(h['epoch_seconds'], 3)) for h in history]}; "
        f"peak allocated {peak_c:.2f} GiB; on {card}")
    log(f"[loop] launches: augment {counts_a}, by head dim {dims_a}; evaluate {counts_e}, by "
        f"head dim {dims_e}")
    shutil.rmtree(work, ignore_errors=True)
    _check_loop_shapes()
    log(f"[loop] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: product loop checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"augment": {"counts": counts_a, "head_dims": dims_a},
            "evaluate": {"counts": counts_e, "head_dims": dims_e},
            "bands": bands, "faults": faults}


# ---- training across ranks ---------------------------------------------------------
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "broadcast",
               "all_gather", "all_gather_object", "barrier")


def rank_worker(spec_path: str) -> int:
    """One rank of phase 5d, 6d or 6e: a gloo rank started by torchrun
    (`chip_smoke.py --rank-worker <spec.json>`), or the one NCCL rank of a
    world of one, called in this script's own process with torchrun's
    environment set (`_nccl_rank_here`): the spec's `kind` ("train": the train CLI,
    `_train_rank`; "serve": the server, `_serve_rank`) in-process on this
    rank's card, with each collective called from Python written to a file
    before it is entered (a crash leaves the last). The spec's `backend:
    gloo` runs the ranks on cuda:0 over a gloo group this worker starts
    (the code under test takes it as the caller's), else NCCL starts on
    LOCAL_RANK's card as in production. Writes `<tag>.rank<r>.json`."""
    import faulthandler
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from psd_tpu_torch.parallel.mesh import TIMEOUT_S

    t_entry = time.time()  # the epoch clock: the launcher reads it too
    faulthandler.enable()  # a crashing rank prints its Python stack into the log
    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    work = Path(spec["work"])
    backend = spec.get("backend", "nccl")
    if backend == "gloo":
        # the ranks share the one card: each is pinned to cuda:0
        os.environ["LOCAL_RANK"] = "0"
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", timeout=timedelta(seconds=TIMEOUT_S))
    trace = open(work / f"{spec['tag']}.rank{rank}.collectives", "w", buffering=1)

    def traced(*a, _call, _name, **k):
        t = next((x for x in (*a, *k.values()) if isinstance(x, torch.Tensor)), None)
        trace.write(f"{_name} {'' if t is None else (tuple(t.shape), str(t.dtype), str(t.device))}\n")
        return _call(*a, **k)

    originals = {name: getattr(dist, name) for name in COLLECTIVES}
    for name in COLLECTIVES:
        setattr(dist, name, functools.partial(traced, _call=originals[name], _name=name))
    run = {"train": _train_rank, "serve": _serve_rank,
           "train_tp": lambda spec_, rank_, _: {"tp": _train_tp_rank(spec_, rank_)}}[
        spec.get("kind", "train")]
    torch.cuda.reset_peak_memory_stats()
    try:
        out = run(spec, rank, work)
        if spec.get("then"):  # a second run in this launch (6d's --fsdp 2 after --dp 2)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out["then"] = run({**spec, **spec["then"], "tp": False, "then": None}, rank, work)
            out["then"].update(rank=rank, world=int(os.environ["WORLD_SIZE"]), backend=backend)
    finally:
        if dist.is_initialized():  # the train CLI ends a group it started itself
            dist.destroy_process_group()
        for name, call in originals.items():  # the rank's own patches too
            setattr(dist, name, call)
        trace.close()
    out.update(rank=rank, world=int(os.environ["WORLD_SIZE"]), backend=backend,
               t_worker=(t_entry, time.time()))
    out.setdefault("peak_gib", torch.cuda.max_memory_allocated() / 2**30)
    (work / f"{spec['tag']}.rank{rank}.json").write_text(json.dumps(out))
    return 0


def _train_rank(spec: dict, rank: int, work: Path) -> dict:
    """Phase 6d's rank: the train CLI's main() as phase 6b runs it, with the
    kernels' launch counts from 0, each phase ending with a synchronize,
    each step's window under torch.profiler (its gloo spans: the time in
    collectives); `fault: no_average` skips DDP's all-reduce by a comm
    hook, else DDP reduces as in production."""
    from torch.profiler import ProfilerActivity, profile

    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.pipelines import train
    from psd_tpu_torch.train import checkpoint, trainer

    snapshot = checkpoint.snapshot
    windows, comm = [], []
    shard, make_step, timer = train.shard_train_state, train.compile_train_step, train.PhaseTimer

    def sharding(state, mesh):
        state = shard(state, mesh)
        if spec.get("fault") == "no_average":
            def skip(_, bucket):
                fut = torch.futures.Future()
                fut.set_result(bucket.buffer())
                return fut

            state.loss.register_comm_hook(None, skip)
        return state

    def stepping(*a, **k):
        step = make_step(*a, **k)

        def timed(*sa, **sk):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                windows.append((t0, time.perf_counter()))
            # gloo's collectives on CUDA tensors are host work (copies, a
            # ring over loopback), each span from its call to its work's
            # completion, DDP's reducer's too; NCCL's complete at the
            # enqueue, so their spans say nothing of the device's time
            comm.append(_gloo_s(prof))
            return out

        return timed

    train.shard_train_state, train.compile_train_step = sharding, stepping
    train.PhaseTimer = lambda device, sync: timer(device, sync=True)
    if spec.get("params_only"):
        checkpoint.snapshot = _params_snapshot
    kernels.reset_launch_counts()
    t0, t_main = time.perf_counter(), time.time()
    try:
        r = train.main(spec["argv"])
    finally:
        train.shard_train_state, train.compile_train_step, train.PhaseTimer = shard, make_step, timer
        checkpoint.snapshot = snapshot
    wall = time.perf_counter() - t0
    out = {"counts": dict(kernels.launch_counts), "head_dims": dict(kernels.attention_head_dims),
           "laps": r["laps"], "wall": wall, "t_main": (t_main, time.time()),
           "steps_s": [b - a for a, b in windows],
           "comm_s": comm if spec.get("backend") == "gloo" else None,
           "sharded": trainer.is_sharded(r["state"]), "device": str(r["state"].model.device),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if spec.get("tp"):  # phase 6e in this launch, the CLI's state freed first
        del r
        gc.collect()
        torch.cuda.empty_cache()
        t_tp = time.time()
        out["tp"] = _train_tp_rank(spec, rank)
        out["t_tp"] = (t_tp, time.time())
    return out


def _params_snapshot(state):
    """`checkpoint.snapshot` of the parameters alone (rank 0's params.pt,
    FSDP2's shards gathered as the checkpoint gathers them): 6d's --fsdp 2
    run, whose gathers of the EMA and the moments over gloo (three quarters
    of its checkpoint) are held bit for bit on the CPU by
    tests/test_torch_train_fsdp.py."""
    from psd_tpu_torch.parallel.mesh import full, rank

    whole = {k: full(p.detach()) for k, p in state.model.core.named_parameters()}
    if rank() != 0:
        return None
    return {"params.pt": {k: w.to("cpu", copy=True) for k, w in whole.items()}}


def _torchrun(work: Path, tag: str, nproc: int, **spec) -> dict:
    """`nproc` ranks under torchrun (rank_worker each, on `spec`); → each
    rank's results, the exit code, the log's tail, and each rank's last
    collective entered. Every process it starts is stopped."""
    import os
    import signal

    spec_path = work / f"{tag}.spec.json"
    spec_path.write_text(json.dumps({"work": str(work), "tag": tag, **spec}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), str(ROOT / "chip_smoke.py"), "--rank-worker", str(spec_path)]
    log_path = work / f"{tag}.log"
    t0, t_spawn = time.perf_counter(), time.time()
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="4"),
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=RANKS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall, t_exit = time.perf_counter() - t0, time.time()
    ranks, last = [], []
    for r in range(nproc):
        res = work / f"{tag}.rank{r}.json"
        ranks.append(json.loads(res.read_text()) if res.exists() else None)
        trace = work / f"{tag}.rank{r}.collectives"
        lines = trace.read_text().splitlines() if trace.exists() else []
        last.append((len(lines), lines[-1] if lines else None))
    text = log_path.read_text().splitlines()
    # a crashed rank's stack (faulthandler), else the log's end
    crash = [i for i, line in enumerate(text) if line.startswith("Fatal Python error")]
    tail = text[crash[0]:crash[0] + 24] if crash else text[-12:]
    return {"rc": rc, "ranks": ranks, "wall": wall, "tail": tail, "last_collective": last,
            "t_spawn": t_spawn, "t_exit": t_exit}


def _nccl_rank_here(work: Path, tag: str, **spec) -> dict:
    """One rank on NCCL in this process, as torchrun would start it alone
    (a world of one: RANK and LOCAL_RANK 0, a free localhost port), running
    `rank_worker` on `spec` without a new process's start (its imports, the
    card's context, the kernels' load); → what `_torchrun` gives. The
    environment is restored after."""
    import os
    import socket

    spec_path = work / f"{tag}.spec.json"
    spec_path.write_text(json.dumps({"work": str(work), "tag": tag, **spec}))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        rc = rank_worker(str(spec_path))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    res = work / f"{tag}.rank0.json"
    return {"rc": rc, "ranks": [json.loads(res.read_text()) if res.exists() else None],
            "wall": wall, "tail": [], "last_collective": []}


def _ranks_failed(phase: str, tag: str, run: dict) -> None:
    """A run that did not end: each rank's count of collectives entered and
    the last, and a crashed rank's stack (faulthandler)."""
    log(f"[{phase}] {tag}: rc {run['rc']}; each rank's collectives entered and the "
        f"last: {run['last_collective']}; log:\n  " + "\n  ".join(run["tail"]))


# ---- serving across ranks -----------------------------------------------------------
def _serve_rank(spec: dict, rank: int, work: Path) -> dict:
    """Phase 5d's rank: a GenerationServer(mesh=) on a (dp, 1) mesh over the
    SD-scale DADD as phase 5 builds it; rank 0 serves phase 5's first
    SERVE_RANKS_REQUESTS requests in each of the spec's rounds ("sound";
    "again", its replays; "fault", each rank's x0 drawn at its own rows)
    and saves their images. Timed on every rank: each batch (from its
    header to its images, synchronized), each gather (synchronized on both
    sides, the wait for the other rank included), then each program's
    replay, one rank at a time."""
    import numpy as np
    import torch.distributed as dist

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from psd_tpu_torch.pipelines.serve import GenerationServer

    mesh = create_mesh(MeshConfig(dp=spec["dp"]), "cuda")
    world = mesh.size()
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    requests = _serve_requests(SERVE_RANKS_BATCH)[:SERVE_RANKS_REQUESTS]
    batches, gathers = [], []
    gather = dist.all_gather_into_tensor

    def timed_gather(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(*a, **k)
        torch.cuda.synchronize()
        gathers.append(time.perf_counter() - t0)
        return out

    dist.all_gather_into_tensor = timed_gather

    class TimedServer(GenerationServer):
        def _generate(self, *a):
            t0 = time.perf_counter()
            out = super()._generate(*a)
            torch.cuda.synchronize()
            batches.append(time.perf_counter() - t0)
            return out

    noise = model.initial_noise

    def own_rows(batch, image_size, generator, shared_noise=True):
        """The planted fault: x0 drawn at a rank's row count, repeated."""
        return noise(batch // world, image_size, generator, shared_noise).repeat(world, 1, 1, 1)

    kernels.reset_launch_counts()
    rounds, counts = {}, {None: {}}
    for name in spec["rounds"]:
        model.initial_noise = own_rows if name == "fault" else noise
        batches.clear()
        gathers.clear()
        server = TimedServer(model, image_size=cfg.dataset.image_size,
                             sampling_steps=SERVE_RANKS_STEPS, steer_scale=1.0,
                             max_batch=SERVE_RANKS_BATCH, max_wait_s=0.05, mesh=mesh)
        wall = None
        if rank == 0:
            images, wall = _serve(server, requests)
            np.save(work / f"{spec['tag']}.{name}.npy", np.stack(images))
        server.close()
        model.initial_noise = noise
        rounds[name] = {"wall_s": wall, "batch_s": list(batches), "gather_s": list(gathers)}
        counts[name] = dict(kernels.launch_counts)
    progs = {key[0]: p for key, p in model.programs.items()}
    programs = {kind: {"launches": dict(p.launches), "replays": p.replays,
                       "warmup_s": p.warmup_s, "capture_s": p.capture_s,
                       "instantiate_s": p.instantiate_s} for kind, p in progs.items()}
    if rank == 0 and world > 1 and spec["rounds"]:
        np.save(work / f"{spec['tag']}.blocks.npy", _one_process_blocks(model, requests, world))
    replay = {}
    for r in range(world):  # one rank's replays at a time on the card
        if r == rank:
            replay = {kind: _replay_ms(p) for kind, p in progs.items()}
        dist.barrier()
    first, last = (spec["rounds"][0], spec["rounds"][-1]) if spec["rounds"] else (None, None)
    out = {"counts": counts[first], "counts_end": counts[last],
           "head_dims": dict(kernels.attention_head_dims), "n_programs": len(model.programs),
           "programs": programs,
           "replay_ms": replay, "rounds": rounds, "device": str(model.device)}
    if spec.get("tp"):
        gathers.clear()
        out["tp"] = _serve_tp_rank(model, cfg, rank, gathers)
    return out


def _serve_tp_rank(model, cfg, rank: int, gathers: list) -> dict:
    """Phase 5f's rank, on 5d's ranks and model: a (dp 1, tp 2) mesh over
    the two. Before the cut, one process's eps and TP_STEPS-step images
    (eagerly) of the server's first batch of 8 (its padded features and
    labels, x0 from its generator); then the UNet cut over tp and (b) the
    eps on the ranks, sound and with each planted fault, (c) sample +
    decode_latents on the mesh (eagerly, the all-reduces synchronized and
    timed, the launches counted from 0), (d) GenerationServer(mesh=) on the
    same 8 requests (rank 0 submits; the launches counted from 0), (f) the
    int8 UNet under tp (`_serve_tp_int8`). → readings, digests of what must
    match across ranks, each path's launches."""
    import hashlib

    import numpy as np
    import torch.nn.functional as F

    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.models import layers
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.parallel import mesh as tp_mesh
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, tp_scope
    from psd_tpu_torch.pipelines.serve import SEED_BASE, GenerationServer

    mesh = create_mesh(MeshConfig(dp=1, tp=TP), "cuda")
    dev, size = model.device, cfg.dataset.image_size
    requests = _serve_requests(TP_BATCH)[:TP_BATCH]
    torch.cuda.reset_peak_memory_stats()

    def digest(t):
        return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def mean_abs(a, b):
        return (a.double() - b.double()).abs().mean().item()

    with torch.inference_mode():
        # the batch as the server builds it (pipelines/serve.py::_dispatch)
        feats = torch.from_numpy(np.stack([r[0] for r in requests])).to(dev)
        labels = torch.tensor([[r[1] for r in requests], [r[2] for r in requests]],
                              dtype=torch.float32, device=dev)
        cond = model.prepare_inference_cond(labels[0], labels[1], feats)
        gen = torch.Generator(device=dev).manual_seed(SEED_BASE + requests[0][3])
        x0 = model.initial_noise(TP_BATCH, size, gen, shared_noise=False)
        g = torch.Generator(device=dev).manual_seed(23)
        side = size // model.spatial_factor
        lat = torch.randn((TP_BATCH, side, side, 4), generator=g, device=dev)
        t = torch.full((TP_BATCH,), 501, dtype=torch.int32, device=dev)

        def eps():
            out = model.core.eps(lat, t, cond, 1.0)
            torch.cuda.synchronize()
            return out

        with eager():
            eps_one = eps()
            images_one = model.decode_latents(model.sample(cond, x0, TP_STEPS, 1.0))
        sites = {name: m for name, m in model.core.unet.named_modules()
                 if getattr(m, "tp_kind", None) == "attention"}
        q_whole = {name: m.to_q.weight.detach().clone() for name, m in sites.items()}
        t0 = time.perf_counter()
        model.shard_tp_(mesh)
        cut_s = time.perf_counter() - t0
        with tp_scope(mesh):
            eps_tp = eps()
            row = layers.row_parallel_linear
            net_2 = {id(m.net_2) for m in model.core.unet.modules()
                     if getattr(m, "tp_kind", None) == "geglu"}

            def own_half(x, layer, dtype, group):
                """The planted fault: rank 1 keeps its own half of net_2's
                product; it still takes part in the all-reduce, so the
                ranks' collectives stay in one order."""
                if rank != 1 or id(layer) not in net_2:
                    return row(x, layer, dtype, group)
                part = F.linear(x.to(dtype), layer.weight.to(dtype))
                tp_mesh.tp_all_reduce(part.clone(), group)
                return part + layer.bias.to(dtype)

            layers.row_parallel_linear = own_half
            try:
                eps_skip = eps()
                with eager():
                    images_skip = model.decode_latents(
                        model.sample(cond, x0, TP_STEPS, 1.0, mesh=mesh), mesh=mesh)
            finally:
                layers.row_parallel_linear = row
            own = {}
            if rank == 1:  # the planted fault: rank 1 runs rank 0's q heads
                for name, m in sites.items():
                    own[name] = m.to_q.weight.data
                    m.to_q.weight.data = q_whole[name][:own[name].shape[0]].contiguous()
            try:
                eps_swap = eps()
            finally:
                for name, w in own.items():
                    sites[name].to_q.weight.data = w
        del q_whole
        eps_reading = {"sound": rel(eps_tp, eps_one), "own net_2 half on rank 1":
                       rel(eps_skip, eps_one), "rank 0's q heads on rank 1":
                       rel(eps_swap, eps_one)}

        # (c): sample + decode on the mesh, each all-reduce synchronized and timed
        reduce, reduce_s = tp_mesh.tp_all_reduce, []

        def timed_reduce(x, group, *op):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = reduce(x, group, *op)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t1)
            return out

        tp_mesh.tp_all_reduce = timed_reduce
        gathers.clear()
        kernels.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with eager():
                images = model.decode_latents(model.sample(cond, x0, TP_STEPS, 1.0, mesh=mesh),
                                              mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tp_mesh.tp_all_reduce = reduce
        counts_c = dict(kernels.launch_counts)
        head_dims = dict(kernels.attention_head_dims)
        gather_c = list(gathers)

    # (d): the server on the mesh, the same 8 requests
    kernels.reset_launch_counts()
    server = GenerationServer(model, image_size=size, sampling_steps=TP_STEPS, steer_scale=1.0,
                              max_batch=TP_BATCH, max_wait_s=0.05, mesh=mesh)
    served = served_wall = None
    if rank == 0:
        served, served_wall = _serve(server, requests)
    server.close()
    counts_d = dict(kernels.launch_counts)
    out = {"eps_rel_l2": eps_reading, "eps_digest": digest(eps_tp),
           "images_digest": digest(images),
           "images_mean_abs": mean_abs(images, images_one),
           "images_fault_mean_abs": mean_abs(images_skip, images_one),
           "images_max_abs": (images.double() - images_one.double()).abs().max().item(),
           "images_ok": bool(torch.isfinite(images).all()) and images.min().item() >= 0.0
           and images.max().item() <= 1.0 and tuple(images.shape) == (TP_BATCH, size, size, 3),
           "wall_s": wall, "all_reduce_s": sum(reduce_s), "all_reduces": len(reduce_s),
           "gather_s": sum(gather_c), "cut_s": cut_s, "counts": counts_c, "counts_server":
           counts_d, "head_dims": head_dims, "tp_heads": next(iter(sites.values())).to_q
           .weight.shape[0], "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if served is not None:
        got = torch.from_numpy(np.stack(served))
        out.update(server_wall_s=served_wall,
                   server_equal_c=bool(torch.equal(got, images.cpu())),
                   server_mean_abs=mean_abs(got, images_one.cpu()))
    model.drop_programs()  # 5d's and (d)'s pools: the int8 UNet's room
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = _serve_tp_int8(mesh, digest, rel)
    return out


def _serve_tp_int8(mesh, digest, rel) -> dict:
    """Phase 5f (f), on a rank of 5f's mesh: phase 5e's int8 UNet
    (`_lever_eps`' weights and inputs, built alike on every rank), quantized
    whole; its one-process eps; each TP_INT8_SITES site's output on one
    seeded input, whole; then the UNet cut over tp (`shard_tp_`): the eps
    on the ranks (the launches counted from 0), and each site on the
    rank's columns of the input, sound and with the planted fault (quant_rows
    dropping the MAX over the tp group)."""
    import copy
    from dataclasses import replace

    from psd_tpu_torch.models import layers
    from psd_tpu_torch.models.init import flax_init_
    from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config
    from psd_tpu_torch.ops import kernels, quant
    from psd_tpu_torch.parallel.mesh import shard_tp_, tp_scope

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = sd14_unet_config(attn_mode="split3", gate_init_anatomy=(0.1, 0.9),
                           gate_init_disease=(0.9, 0.1), dtype=bf16)
    with dev:
        plain = UNet2DCondition(cfg).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    flax_init_(plain, g)
    x = torch.randn((8, 64, 64, 4), generator=g, device=dev)
    t = torch.full((8,), 501, dtype=torch.int32, device=dev)
    ctx = torch.randn((8, 48, 768), generator=g, device=dev)
    fp32 = {k: v.clone() for k, v in plain.state_dict().items()}
    del plain
    q8cfg = replace(cfg, quant="int8")
    with dev:
        unet = UNet2DCondition(q8cfg).eval()
    unet.load_state_dict(_spread_gains_(unet, fp32, torch.Generator(device=dev).manual_seed(5)))
    del fp32
    layers.quantize_int8_weights_(unet)
    layers.store_weights_in_(unet, bf16)
    gc.collect()
    torch.cuda.empty_cache()
    gx = torch.Generator(device=dev).manual_seed(7)
    out = {"sites": {}}
    with torch.inference_mode():
        eps_one = unet(x, t, ctx, 1.0)
        inputs, whole = {}, {}
        for key, (path, name, rows) in TP_INT8_SITES.items():
            site = unet.get_submodule(path)
            K = getattr(site, name).in_features
            inputs[key] = torch.randn((rows, K), generator=gx, device=dev).to(bf16)
            whole[key] = layers.int8_linear(inputs[key], copy.deepcopy(site), name, bf16)
        torch.cuda.synchronize()
        shard_tp_(unet, mesh)
        rows_quant = quant.quant_rows
        with tp_scope(mesh):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            eps_tp = unet(x, t, ctx, 1.0)
            torch.cuda.synchronize()
            out["eps_wall_s"] = time.perf_counter() - t0
            out["counts"] = dict(kernels.launch_counts)
            out["head_dims"] = dict(kernels.attention_head_dims)
            for key, (path, name, _) in TP_INT8_SITES.items():
                m = unet.get_submodule(path)
                k = inputs[key].shape[-1] // m.tp.size
                mine = inputs[key][:, m.tp.rank * k:(m.tp.rank + 1) * k]
                sound = layers.int8_linear(mine, m, name, bf16, m.tp.group)
                quant.quant_rows = lambda x_, group=None: rows_quant(x_)
                try:
                    fault = layers.int8_linear(mine, m, name, bf16, m.tp.group)
                finally:
                    quant.quant_rows = rows_quant
                out["sites"][key] = {
                    "cols": k, "equal": bool(torch.equal(sound, whole[key])),
                    "fault_equal": bool(torch.equal(fault, whole[key])),
                    "fault_rel_l2": rel(fault, whole[key]),
                    "max_abs": (sound.float() - whole[key].float()).abs().max().item()}
        out.update(eps_rel_l2=rel(eps_tp, eps_one), eps_digest=digest(eps_tp),
                   eps_finite=bool(torch.isfinite(eps_tp).all()))
    del unet, eps_one, eps_tp, inputs, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _one_process_blocks(model, requests, world: int):
    """What one process gives at a rank's rows, without a mesh: each of the
    server's batches as it pads it (features with the last request's,
    labels with 0) and seeds it (SEED_BASE + the leading request's seed),
    the batch's x0 drawn whole, then each rank's rows sampled and decoded
    on their own (the ranks' programs, replayed) → the requests' images."""
    import numpy as np

    from psd_tpu_torch.parallel.mesh import shard_rows
    from psd_tpu_torch.pipelines.serve import SEED_BASE

    B, out = SERVE_RANKS_BATCH, []
    size, steps = model.cfg.dataset.image_size, SERVE_RANKS_STEPS
    for i in range(0, len(requests), B):
        batch = requests[i:i + B]
        n = len(batch)
        feats = np.stack([r[0] for r in batch] + [batch[-1][0]] * (B - n))
        cond = model.prepare_inference_cond(
            np.asarray([r[1] for r in batch] + [0.0] * (B - n), np.float32),
            np.asarray([r[2] for r in batch] + [0.0] * (B - n), np.float32), feats)
        gen = torch.Generator(device=model.device).manual_seed(SEED_BASE + batch[0][3])
        x0 = model.initial_noise(B, size, gen, shared_noise=False)
        images = []
        for r in range(world):
            rows = shard_rows(B, world, 1, r, 0)
            images.append(model.decode_latents(model.sample(cond[rows], x0[rows], steps, 1.0)))
        out.append(torch.cat(images)[:n].cpu().numpy())
    return np.concatenate(out)


def _check_serve_rank_shapes() -> None:
    """Each serving kernel against its plain version by its judge at a
    rank's 4 rows (SERVE_RANK_*; not timed, not counted)."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    checks = []
    for shape in SERVE_RANK_ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        checks.append(("attention", shape, attention_judge(
            attention.attention_fwd(q, k, v), attention.attention_reference(q, k, v))))
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in SERVE_RANK_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
            split3.split3_reference(q, *banks, d1, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[serve_ranks] {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C in SERVE_RANK_LN_SHAPES:
        _check_ln_edge(randn, M, C, C, 4 * C, 0.0)
    for B, S, C in SERVE_RANK_GN_SHAPES:
        _check_gn_edge(randn, B, S, C, C, 0.0)
    torch.cuda.empty_cache()


def _tp_kernels(results: dict) -> None:
    """Phase 5f (a): each kernel of the tp serving path at a rank's shapes
    (TP_*), against its plain version by its judge, timed as phase 3 times
    it (kernel, plain, library: SDPA for the attention; the cuBLAS product
    of the same size beside the LayerNorm GEMMs, kept as
    `cublas_product_ms`), kept under "tp_shapes" outside the entries' sums;
    then tp 4's shapes (TP4_*), untimed."""
    from psd_tpu_torch.ops import attention, geglu, split3
    from psd_tpu_torch.testing import attention_judge, ln_gemm_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    for shape in TP_ATTN_SHAPES:
        B, S, H, D = shape
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        _compare("attention", shape, lambda: attention.attention_fwd(q, k, v),
                 lambda: attention.attention_reference(q, k, v), results,
                 (4.0 * B * H * S * S * D, 4 * B * S * H * D * 2),
                 fn_library=lambda: _sdpa(q, k, v), judge=attention_judge,
                 note={"exp2_ms_at_sfu_rate": B * H * S * S / sfu_exp2_per_s() * 1e3},
                 key="tp_shapes")
        del q, k, v
        torch.cuda.empty_cache()
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in TP_SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, d1, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2),
                 judge=split3_judge, key="tp_shapes",
                 note={"device_ms": graph_ms(
                     lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9))})
    for (M, C) in TP_LN_SHAPES:
        N = C // TP
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        xhat = geglu.ln_reference(x, lw, lb)  # the cuBLAS yardstick's A
        for n_out in (3, 1):
            ws = tuple(randn(N, C, std=C ** -0.5) for _ in range(n_out))
            wcat = torch.cat(ws)
            _compare("ln_proj", (M, C, N, n_out), lambda: geglu.ln_proj_fwd(x, lw, lb, ws),
                     lambda: geglu.ln_proj_reference(x, lw, lb, ws), results,
                     (2.0 * M * C * N * n_out,
                      M * C * 2 + 2 * C * 4 + n_out * (N * C * 2 + M * N * 2)),
                     judge=ln_gemm_judge, key="tp_shapes",
                     extra={"cublas_product_ms": time_ms(lambda: torch.matmul(xhat, wcat.T))},
                     note={"device_ms": graph_ms(lambda: geglu.ln_proj_fwd(x, lw, lb, ws))})
        w0 = randn(8 * N, C, std=C ** -0.5)  # [h_r ; g_r]: 4C/tp rows a half
        b0 = randn(8 * N, std=0.02, dtype=torch.float32)
        _compare("ln_geglu", (M, C, 4 * N), lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                 lambda: geglu.ln_geglu_reference(x, lw, lb, w0, b0), results,
                 (2.0 * M * C * 8 * N,
                  M * C * 2 + 2 * C * 4 + 8 * N * C * 2 + 8 * N * 4 + M * 4 * N * 2),
                 judge=ln_gemm_judge, key="tp_shapes",
                 extra={"cublas_product_ms": time_ms(lambda: torch.matmul(xhat, w0.T))},
                 note={"device_ms": graph_ms(lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0))})
        del x, xhat, w0
        torch.cuda.empty_cache()
    checks = []
    for shape in TP4_ATTN_EDGE:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        checks.append(("attention", shape, attention_judge(
            attention.attention_fwd(q, k, v), attention.attention_reference(q, k, v))))
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in TP4_SPLIT3_EDGE:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        checks.append(("split3", (B, S, H, D), split3_judge(
            split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
            split3.split3_reference(q, *banks, d1, 0.1, 0.9))))
    for name, shape, (ok, text, _) in checks:
        log(f"[serve_tp] tp 4: {name} {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")
    for M, C, n_proj, n_geglu in TP4_LN_EDGE:
        _check_ln_edge(randn, M, C, n_proj, n_geglu, 0.0)
    torch.cuda.empty_cache()


def _check_serve_tp(card: str, ranks: list, cfg) -> dict:
    """Phase 5f's checks on its ranks' readings (`_serve_tp_rank`): (b) the
    eps within TP_EPS_BAND of one process's and each planted fault beyond
    it, every rank's eps the same; (c) the images every rank's the same,
    within TP_IMAGE_BAND (mean) of one process's; (d) the server's images
    (rank 0) equal (c)'s and so within the band; (e) each rank's launches
    those route_launches gives a rank's cut sites: (c) TP_STEPS eager
    evaluations and the decode, (d) the same with the decode at its
    program's warm-up and capture; (f) the int8 UNet's row-parallel int8
    sites bit-equal to the whole sites and the planted per-rank-scale fault
    not, its eps within TP_EPS_BAND of one process's and the same on every
    rank, its launches the routes' at tp. Prints each rank's synced wall,
    its time in the all-reduces and peak memory."""
    from psd_tpu_torch.diffusion.dadd import DADDCoreConfig, core_config_from
    from psd_tpu_torch.models.unet import sd14_unet_config
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.testing import route_launches

    size = cfg.dataset.image_size
    core_cfg = core_config_from(cfg)

    def route(steps, decode):
        return Counter(route_launches(core_cfg, VAEConfig(), TP_BATCH, size, steps, decode=decode,
                                      tp=TP))

    want_c = route(TP_STEPS, True)
    want_d = route(TP_STEPS, False) + route(0, True) + route(0, True)
    q8cfg = sd14_unet_config(attn_mode="split3", quant="int8")
    want_f = route_launches(DADDCoreConfig(unet=q8cfg), VAEConfig(), TP_BATCH, size, 1,
                            decode=False, tp=TP)
    want_c, want_d, want_f = ({k: n for k, n in w.items() if n} for w in (want_c, want_d, want_f))
    tps = [r["tp"] for r in ranks]
    for r, t in zip(ranks, tps):
        q = t["int8"]
        sites = "; ".join(f"{k}: {v['cols']} columns a rank, bit-equal {v['equal']} (max abs "
                          f"{v['max_abs']:.3e}), the per-rank-scale fault bit-equal "
                          f"{v['fault_equal']} (rel L2 {v['fault_rel_l2']:.3e})"
                          for k, v in q["sites"].items())
        log(f"[serve_tp] (f) rank {r['rank']}: the int8 UNet's eps on the ranks against one "
            f"process rel L2 {q['eps_rel_l2']:.4e} (band {TP_EPS_BAND:g}), {q['eps_wall_s']:.3f} "
            f"s eager; launches {q['counts']}, the routes' {want_f}; by head dim "
            f"{q['head_dims']}; row-parallel int8 sites: {sites}; on {card}")
    for r, t in zip(ranks, tps):
        eps = ", ".join(f"{k} {v:.4e}" for k, v in t["eps_rel_l2"].items())
        log(f"[serve_tp] rank {r['rank']}/{r['world']} over {r['backend']}: eps rel L2 against "
            f"one process: {eps}; {TP_STEPS}-step images against one process: mean abs "
            f"{t['images_mean_abs']:.4e}, max abs {t['images_max_abs']:.4e}, the net_2 fault's "
            f"mean abs {t['images_fault_mean_abs']:.4e}; sample + decode "
            f"wall {t['wall_s']:.3f} s (synced), {t['all_reduces']} all-reduces "
            f"{t['all_reduce_s']:.3f} s (each synced), gathers {t['gather_s']:.3f} s; the cut "
            f"{t['cut_s']:.3f} s; peak {t['peak_gib']:.3f} GiB; launches (c) {t['counts']}, "
            f"by head dim {t['head_dims']}, (d) {t['counts_server']}; to_q rows {t['tp_heads']}"
            + (f"; server wall {t['server_wall_s']:.3f} s, mean abs against one process "
               f"{t['server_mean_abs']:.4e}" if "server_wall_s" in t else "") + f"; on {card}")
    t0 = tps[0]
    eps = t0["eps_rel_l2"]
    faults = {k: v for k, v in eps.items() if k != "sound"}
    checks = {
        f"(b) eps within {TP_EPS_BAND:g} of one process": eps["sound"] <= TP_EPS_BAND,
        f"(b) each planted fault beyond {TP_EPS_BAND:g} {faults}": all(
            v > TP_EPS_BAND for v in faults.values()),
        "(b) every rank's eps the same": len({t["eps_digest"] for t in tps}) == 1,
        "(c) images (8, 512, 512, 3), finite, in [0, 1]": all(t["images_ok"] for t in tps),
        "(c) every rank's images the same": len({t["images_digest"] for t in tps}) == 1,
        f"(c) within {TP_IMAGE_BAND:g} (mean) of one process": t0["images_mean_abs"]
            <= TP_IMAGE_BAND,
        f"(c) the net_2 fault's images beyond {TP_IMAGE_BAND:g}": t0["images_fault_mean_abs"]
            > TP_IMAGE_BAND,
        "(d) the server's images equal (c)'s": t0.get("server_equal_c") is True,
        f"(d) within {TP_IMAGE_BAND:g} (mean) of one process": t0.get("server_mean_abs", 1.0)
            <= TP_IMAGE_BAND,
        f"(e) (c) launches the routes' at tp {TP} {want_c}": all(
            {k: n for k, n in t["counts"].items() if n} == want_c for t in tps),
        f"(e) (d) launches the routes' at tp {TP} {want_d}": all(
            {k: n for k, n in t["counts_server"].items() if n} == want_d for t in tps),
        f"a rank's to_q holds C/{TP} rows": all(t["tp_heads"] == 320 // TP for t in tps),
        "(f) each row-parallel int8 site bit-equal to the whole site": all(
            v["equal"] for t in tps for v in t["int8"]["sites"].values()),
        "(f) the per-rank-scale fault not bit-equal": not any(
            v["fault_equal"] for t in tps for v in t["int8"]["sites"].values()),
        f"(f) the int8 eps within {TP_EPS_BAND:g} of one process": all(
            t["int8"]["eps_finite"] and t["int8"]["eps_rel_l2"] <= TP_EPS_BAND for t in tps),
        "(f) every rank's int8 eps the same": len({t["int8"]["eps_digest"] for t in tps}) == 1,
        f"(f) the int8 eps launches the routes' at tp {TP} {want_f}": all(
            {k: n for k, n in t["int8"]["counts"].items() if n} == want_f for t in tps),
    }
    log(f"[serve_tp] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: serve tp checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    counts = {k: n + t0["counts_server"].get(k, 0) + t0["int8"]["counts"].get(k, 0)
              for k, n in t0["counts"].items()}
    dims = Counter({int(k): v for k, v in t0["head_dims"].items()})
    dims.update({int(k): v for k, v in t0["int8"]["head_dims"].items()})
    return {"counts": counts, "head_dims": dict(dims), "ranks": tps}


def phase_serve_tp(card: str, results: dict) -> dict:
    """Phase 5f alone (5d runs it after its own checks, in its launch): two
    ranks on cuda:0 over gloo, the tp checks, then the kernels at the tp
    shapes."""
    import shutil

    from psd_tpu_torch.core.config import load_config

    work = ROOT / "build" / "psd_tpu_torch" / "serve_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    run = _torchrun(work, "tp_gloo", 2, kind="serve", dp=2, rounds=[], tp=True, backend="gloo")
    if run["rc"] != 0 or not all(run["ranks"]):
        _ranks_failed("serve_tp", "tp_gloo", run)
        raise SystemExit(f"chip_smoke.py: serve tp did not run to its end (rc {run['rc']})")
    log(f"[serve_tp] torchrun wall {run['wall']:.1f} s")
    tp = _check_serve_tp(card, run["ranks"], cfg)
    _tp_kernels(results)
    shutil.rmtree(work, ignore_errors=True)
    return tp


def phase_serve_ranks(card: str, served: dict, results: dict) -> dict:
    """GenerationServer(mesh=) across ranks (phase 5d), started by torchrun:
    two ranks on cuda:0 over gloo at dp 2 (sound, again, the planted
    fault), then one rank on NCCL at dp 1 in this process; rank 0's images against phase
    5's one-process server on the same requests (SERVE_RANKS_BAND at dp 2,
    bit for bit at dp 1), each rank's launches against the routes' at its
    rows; then the kernels at a rank's rows. Phase 5f runs in the gloo
    launch after 5d's rounds (`_serve_tp_rank`); its checks and its kernels
    at the tp shapes follow 5d's."""
    import shutil

    import numpy as np

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import core_config_from
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.testing import route_launches

    work = ROOT / "build" / "psd_tpu_torch" / "serve_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    ref = np.stack(served["images12_ranks"])

    def diff(images, want=ref):
        d = np.abs(images.astype(np.float64) - want)
        return float(d.max()), float(d.mean())

    def run_ranks(tag, dp, rounds, **spec):
        if spec.get("backend") == "gloo":
            run = _torchrun(work, tag, dp, kind="serve", dp=dp, rounds=rounds, **spec)
        else:  # one rank on NCCL: in this process
            run = _nccl_rank_here(work, tag, kind="serve", dp=dp, rounds=rounds, **spec)
        if run["rc"] != 0 or not all(run["ranks"]):
            _ranks_failed("serve_ranks", tag, run)
            raise SystemExit(f"chip_smoke.py: serve ranks {tag} did not run to its end "
                             f"(rc {run['rc']})")
        run["images"] = {name: np.load(work / f"{tag}.{name}.npy") for name in rounds}
        rows = SERVE_RANKS_BATCH // dp
        want = route_launches(core_config_from(cfg), VAEConfig(), rows, cfg.dataset.image_size,
                              SERVE_RANKS_STEPS)
        want = {k: n for k, n in want.items() if n}
        for r in run["ranks"]:
            progs = r["programs"]
            launched = dict(sum((Counter(p["launches"]) for p in progs.values()), Counter()))
            host = {k: n for k, n in r["counts"].items() if n}
            r["checks"] = {
                "two programs (sample, decode)": r["n_programs"] == 2
                    and set(progs) == {"sample", "decode"},
                f"one replay a batch each ({2 * len(rounds)})": all(
                    p["replays"] == 2 * len(rounds) for p in progs.values()),
                f"sample + decode launch the routes' at {rows} rows {want}": launched == want,
                "host counts = warm-up + capture": host == {k: 2 * n for k, n in want.items()},
                "later rounds replay only": r["counts_end"] == r["counts"],
                "attention saw D=40, 80 (UNet) and 512 (VAE)": all(
                    r["head_dims"].get(str(d), 0) > 0 for d in (40, 80, 512)),
            }
            rd = r["rounds"]
            log(f"[serve_ranks] {tag} rank {r['rank']}/{r['world']} on {r['device']} over "
                f"{r['backend']}: {rows} rows a batch; batch wall s (synced) by round "
                f"{ {k: [round(x, 4) for x in v['batch_s']] for k, v in rd.items()} }; in the "
                f"gathers s {({k: [round(x, 4) for x in v['gather_s']] for k, v in rd.items()})}; "
                f"rank 0's 12 requests s {({k: v['wall_s'] for k, v in rd.items()})}; one replay "
                f"device ms / host ms until replay() returns: "
                + ", ".join(f"{k} {v['device_ms']:.2f} / {v['host_launch_ms']:.2f}"
                            for k, v in r["replay_ms"].items())
                + f"; warm-up / capture / instantiation s "
                f"{ {k: (round(p['warmup_s'], 3), round(p['capture_s'], 3), round(p['instantiate_s'], 3)) for k, p in progs.items()} }; "  # noqa: E501
                f"peak {r['peak_gib']:.3f} GiB; host launches {r['counts']}, by head dim "
                f"{r['head_dims']}; on {card}")
            log(f"[serve_ranks] {tag} rank {r['rank']} checks {r['checks']}")
        how = "torchrun" if spec.get("backend") == "gloo" else "in this process"
        log(f"[serve_ranks] {tag}: wall {run['wall']:.1f} s ({how}), rc {run['rc']}")
        return run

    gloo = run_ranks("dp2_gloo", 2, ["sound", "again", "fault"], backend="gloo", tp=True)
    imgs = gloo["images"]
    blocks = np.load(work / "dp2_gloo.blocks.npy")
    sound, fault = diff(imgs["sound"]), diff(imgs["fault"])
    log(f"[serve_ranks] dp 2 over gloo, rank 0's 12 images against phase 5's one process, "
        f"max / mean abs: sound {sound[0]:.4e} / {sound[1]:.4e}, the planted fault (x0 at a "
        f"rank's rows) {fault[0]:.4e} / {fault[1]:.4e}; band (mean) {SERVE_RANKS_BAND:g}; "
        f"against one process at 4 rows: sound {diff(imgs['sound'], blocks)}, the fault "
        f"{diff(imgs['fault'], blocks)}, phase 5 {diff(blocks)}")
    checks = {
        "dp 2: shape (12, 512, 512, 3), finite, in [0, 1]": imgs["sound"].shape == ref.shape
            and bool(np.isfinite(imgs["sound"]).all()) and imgs["sound"].min() >= 0.0
            and imgs["sound"].max() <= 1.0,
        f"dp 2: within {SERVE_RANKS_BAND:g} (mean) of phase 5": sound[1] <= SERVE_RANKS_BAND,
        f"dp 2: the planted fault beyond {SERVE_RANKS_BAND:g}": fault[1] > SERVE_RANKS_BAND,
        "dp 2: equal to one process at a rank's rows": np.array_equal(imgs["sound"], blocks),
        "dp 2: the planted fault not": not np.array_equal(imgs["fault"], blocks),
        "dp 2: replayed again bit for bit": np.array_equal(imgs["again"], imgs["sound"]),
        "dp 2: every rank's checks": all(all(r["checks"].values()) for r in gloo["ranks"]),
    }
    nccl = run_ranks("dp1_nccl", 1, ["sound"])
    checks["dp 1 on NCCL: equal to phase 5 bit for bit"] = np.array_equal(
        nccl["images"]["sound"], ref)
    checks["dp 1 on NCCL: its checks"] = all(nccl["ranks"][0]["checks"].values())
    log(f"[serve_ranks] dp 1 on NCCL against phase 5: max / mean abs "
        f"{diff(nccl['images']['sound'])}")
    log(f"[serve_ranks] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: serve ranks checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    _check_serve_rank_shapes()
    tp = _check_serve_tp(card, gloo["ranks"], cfg)
    _tp_kernels(results)
    shutil.rmtree(work, ignore_errors=True)
    r0 = gloo["ranks"][0]
    return {"counts": r0["counts"], "head_dims": {int(k): v for k, v in r0["head_dims"].items()},
            "sound": sound, "fault": fault, "ranks": gloo["ranks"] + nccl["ranks"], "tp": tp}


def _params(step_dir: Path) -> dict:
    """A step directory's params.pt, memory-mapped."""
    return torch.load(step_dir / "params.pt", map_location="cpu", weights_only=True, mmap=True)


def _flat_rel(a: dict, b: dict, start: dict, keys=None) -> tuple:
    """(‖a − b‖ / ‖b‖, ‖a − b‖ / ‖b − start‖) over every parameter of two
    sets of parameters (name → tensor), or over `keys`, summed on the card
    in float64."""
    diff = norm = upd = torch.zeros((), dtype=torch.float64, device="cuda")
    for k in (b if keys is None else keys):
        w = b[k]
        x, y, z = (t.to("cuda", torch.float64) for t in (a[k], w, start[k]))
        diff, norm, upd = diff + (x - y).square().sum(), norm + y.square().sum(), \
            upd + (y - z).square().sum()
    return (diff / norm).sqrt().item(), (diff / upd).sqrt().item()


def _logged(out: Path) -> list:
    return [r for r in (json.loads(line) for line in
                        (out / "metrics.jsonl").read_text().splitlines()) if "loss" in r]


def _check_rank_shapes() -> None:
    """Each kernel of the ranks' path against its plain version by its judge
    at the rows a rank (16) and the one process (32) give it: the attention
    forward and backward at the 32×32 sites, the VAE encoder's mid-block
    attention, split3 (not timed, not counted)."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape in RANKS_ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        ok, text, _ = attention_judge(attention.attention_fwd(q, k, v),
                                      attention.attention_reference(q, k, v))
        log(f"[train_ranks] attention {shape}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: attention {shape} disagrees with its plain version")
        if shape[-1] == 40:
            _check_attention_bwd(q, k, v, randn(*shape), f"{shape} (not timed)")
        del q, k, v
    d0 = _delta(0.0)  # δ as the model passes it, in device memory
    for (B, S, H, D) in RANKS_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        ok, text, _ = split3_judge(split3.split3_fwd(q, *banks, d0, 0.1, 0.9),
                                   split3.split3_reference(q, *banks, d0, 0.1, 0.9))
        log(f"[train_ranks] split3 {(B, S, H, D)}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: split3 {(B, S, H, D)} disagrees with its plain "
                             "version")
    torch.cuda.empty_cache()


# ---- the tp train step (phase 6e) --------------------------------------------------------
@contextlib.contextmanager
def _tp_f_off_context():
    """The planted fault: no f on the cross-attention's context tokens (the
    conditioning modules then get a part of their gradient on each tp
    rank), told from the sites' hidden tokens by their count."""
    from psd_tpu_torch.models import layers

    copy = layers.copy_to_tp
    layers.copy_to_tp = lambda x, group: (x if x.shape[1] == TRAIN_TP_CONTEXT_TOKENS
                                          else copy(x, group))
    try:
        yield
    finally:
        layers.copy_to_tp = copy


@contextlib.contextmanager
def _tp_g_reducing_backward():
    """The planted fault: g's backward all-reduces too, as
    torch.distributed.nn.functional.all_reduce's does (the residual
    stream's gradient tp times too large at every row-parallel site)."""
    from psd_tpu_torch.models import layers
    from psd_tpu_torch.parallel import mesh

    class Both(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return mesh.tp_all_reduce(x.clone(), group)

        @staticmethod
        def backward(ctx, grad):
            return mesh.tp_all_reduce(grad.clone(), ctx.group), None

    reduce = layers.reduce_from_tp
    layers.reduce_from_tp = lambda x, group: x if group is None else Both.apply(x, group)
    try:
        yield
    finally:
        layers.reduce_from_tp = reduce


TRAIN_TP_FAULTS = {"f off the context": _tp_f_off_context,
                   "g all-reducing backward": _tp_g_reducing_backward}


def _union(spans) -> float:
    """The length of a union of (start, end) spans."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        s = max(s, end)
        if e > s:
            total, end = total + e - s, e
    return total


def _gloo_s(prof) -> float:
    """The seconds of a profiled window in gloo's collectives: the union of
    its "gloo:" spans, from the raw events (torch's FunctionEvents take
    seconds to build for a training step's 100k host ops)."""
    return _union((e.start_ns() / 1e9, e.end_ns() / 1e9)
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("gloo:"))


def _train_tp_rank(spec: dict, rank: int) -> dict:
    """Phase 6e's rank, on 6d's ranks (two on cuda:0 over gloo): a (dp 1,
    tp 2) mesh over them; rank 0 first takes the one-process step on the
    SD-scale DADD (seed 0) at TRAIN_TP_BATCH seeded rows and draws, keeping
    the initial and the stepped parameters on the host, while rank 1 waits;
    then both build the same model, `shard_train_state` it on the mesh and
    take the same step through `make_train_step` (synced, its gloo spans
    under torch.profiler, the launches counted from 0), sound and then with
    each of the spec's planted `faults`; rank 0 reads the snapshot (the
    checkpoint's gather) of the sound run, the gathered parameters of a
    faulted one, and each run's updates against the one process's (flat
    and by TRAIN_TP_MODULES)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.parallel.mesh import (MeshConfig, create_mesh, shard_batch, tp_cuts,
                                             tp_gather)
    from psd_tpu_torch.train import create_train_state, make_train_step
    from psd_tpu_torch.train.checkpoint import snapshot
    from psd_tpu_torch.train.trainer import shard_train_state

    mesh = create_mesh(MeshConfig(dp=1, tp=TP), "cuda")
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["training.update_starting_at_step=0"])
    dev, B = torch.device("cuda"), TRAIN_TP_BATCH
    lat = cfg.dataset.image_size // 8
    g = torch.Generator(device=dev).manual_seed(41)
    batch = {"latents": torch.randn((B, lat, lat, 4), generator=g, device=dev),
             "labels": torch.randint(0, 4, (B,), generator=g, device=dev).float(),
             "clip_feats": torch.randn((B, 257, 1024), generator=g, device=dev)}

    def built():
        model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0, for_training=True)
        state, tx = create_train_state(model)
        draws = model.sample_draws((B, lat, lat, 4), torch.Generator(device=dev).manual_seed(42))
        return model, state, tx, draws

    def host(named):
        return {k: v.detach().to("cpu", copy=True) for k, v in named.items()}

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"runs": {}}
    if rank == 0:
        model, state, tx, draws = built()
        start = host(dict(model.core.named_parameters()))
        step = make_train_step(model, tx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws=draws)
        torch.cuda.synchronize()
        out["one"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "step_s": time.perf_counter() - t0}
        after = host(dict(model.core.named_parameters()))
        del model, state, tx, step, draws, m
        freed()
    dist.barrier()
    for name in ["sound"] + list(spec.get("faults", [])):
        model, state, tx, draws = built()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = shard_train_state(state, mesh)
        shard_s = time.perf_counter() - t0
        step = make_train_step(model, tx, mesh)
        mine = shard_batch(mesh, batch)
        kernels.reset_launch_counts()
        with TRAIN_TP_FAULTS[name]() if name in TRAIN_TP_FAULTS else contextlib.nullcontext():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                state, m = step(state, mine, draws=draws)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        run = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step_s": wall,
               "shard_s": shard_s, "comm_s": _gloo_s(prof),
               "counts": dict(kernels.launch_counts),
               "head_dims": dict(kernels.attention_head_dims),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "local_to_q": tuple(dict(model.core.named_parameters())[
                   f"{TRAIN_TP_SITE}.attn1.to_q.weight"].shape)}
        del prof
        if name == "sound":  # the checkpoint's gather: rank 0's one-card snapshot
            t0 = time.perf_counter()
            snap = snapshot(state)
            run["snapshot_s"] = time.perf_counter() - t0
            params = None if snap is None else snap["params.pt"]
            if snap is not None:
                run["checkpoint_like_one_card"] = all(
                    {k: tuple(v.shape) for k, v in tensors.items()}
                    == {k: tuple(v.shape) for k, v in start.items()}
                    for tensors in (snap["params.pt"], snap["ema.pt"],
                                    snap["optimizer.pt"]["exp_avg"],
                                    snap["optimizer.pt"]["exp_avg_sq"]))
            del snap
        else:
            cuts, params = tp_cuts(model.core), {} if rank == 0 else None
            for k, p in model.core.named_parameters():
                w = p.detach()
                if k in cuts:
                    dim, halves, cut = cuts[k]
                    w = tp_gather(w, dim, halves, cut)
                if params is not None:
                    params[k] = w.to("cpu", copy=True)
        if name == "sound":  # a second step: the first one's warm-up left out
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                step(state, mine, draws=draws)
                torch.cuda.synchronize()
                run["steady_step_s"] = time.perf_counter() - t0
            run["steady_comm_s"] = _gloo_s(prof)
            run["steady_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            del prof
        if rank == 0:
            run["update_rel"] = _flat_rel(params, after, start)[1]
            run["modules"] = {}
            for mod, pattern in TRAIN_TP_MODULES.items():
                keys = [k for k in start if pattern.fullmatch(k)]
                run["modules"][mod] = (_flat_rel(params, after, start, keys)[1], len(keys))
        out["runs"][name] = run
        del model, state, tx, step, draws, m, params
        freed()
        dist.barrier()
    return out


def _check_train_tp(card: str, ranks: list, per_step: dict, strict: bool = True) -> dict:
    """Phase 6e's checks on its ranks' readings (`_train_tp_rank`): the sound
    run's loss, grad norm and flattened update against the one-process step
    within 6d's bands, each TRAIN_TP_MODULES update within
    TRAIN_TP_MODULE_BAND, rank 0's checkpoint gathered whole in the one-card
    names and shapes, each rank's launches phase 6's per step (the
    attention forward at D = 40 only), a rank's to_q cut in half. Prints
    each run's readings (the planted faults' beside); raises on a failed
    check where `strict`."""
    runs = [r["tp"]["runs"] for r in ranks]
    one = ranks[0]["tp"]["one"]
    for r, by_name in zip(ranks, runs):
        for name, run in by_name.items():
            extra = ""
            if "update_rel" in run:
                mods = ", ".join(f"{k} {v:.3e} ({n} tensors)" for k, (v, n) in
                                 run["modules"].items())
                extra = (f"; update against the one process's {run['update_rel']:.3e} (band "
                         f"{RANKS_UPDATE_BAND:g}), by module: {mods}")
            log(f"[train_tp] {name} rank {r['rank']}/{r['world']} over {r['backend']}: loss "
                f"{run['loss']:.6f} (one process {one['loss']:.6f}), grad norm "
                f"{run['grad_norm']:.6f} ({one['grad_norm']:.6f}); step {run['step_s']:.3f} s "
                f"synced, {run['comm_s']:.3f} s in gloo ({run['comm_s'] / run['step_s']:.3f} of "
                f"it), shard_train_state {run['shard_s']:.3f} s; peak {run['peak_gib']:.2f} GiB; "
                f"launches {run['counts']}, by head dim {run['head_dims']}; to_q "
                f"{run['local_to_q']}" + (f"; snapshot {run['snapshot_s']:.3f} s"
                                          if "snapshot_s" in run else "")
                + (f"; a second step {run['steady_step_s']:.3f} s synced, "
                   f"{run['steady_comm_s']:.3f} s in gloo "
                   f"({run['steady_comm_s'] / run['steady_step_s']:.3f} of it), peak "
                   f"{run['steady_peak_gib']:.2f} GiB" if "steady_step_s" in run else "") + extra
                + f"; one process's step {one['step_s']:.3f} s; on {card}")
    sound = runs[0]["sound"]
    loss_rel = abs(sound["loss"] - one["loss"]) / abs(one["loss"])
    norm_rel = abs(sound["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
    want = {k: n for k, n in per_step.items() if n}
    checks = {
        f"loss within rtol {RANKS_LOSS_RTOL:g}": loss_rel <= RANKS_LOSS_RTOL,
        f"grad norm within rtol {RANKS_NORM_RTOL:g}": norm_rel <= RANKS_NORM_RTOL,
        f"update difference ≤ {RANKS_UPDATE_BAND:g}": sound["update_rel"] <= RANKS_UPDATE_BAND,
        f"each module's update ≤ {TRAIN_TP_MODULE_BAND:g}": all(
            v <= TRAIN_TP_MODULE_BAND and n > 0 for v, n in sound["modules"].values()),
        "rank 0's checkpoint in the one-card names and shapes": sound.get(
            "checkpoint_like_one_card") is True,
        f"each rank's launches phase 6's per step {want}": all(
            {k: n for k, n in r["sound"]["counts"].items() if n} == want for r in runs),
        "attention forward at D=40 only": all(set(r["sound"]["head_dims"]) == {"40"}
                                              for r in runs),
        "every rank's loss the same": len({r["sound"]["loss"] for r in runs}) == 1,
        f"a rank's to_q holds 320/{TP} rows": all(
            r["sound"]["local_to_q"] == [320 // TP, 320] for r in runs),
    }
    log(f"[train_tp] loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e}; checks {checks}")
    if strict and not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: train tp checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"counts": sound["counts"], "head_dims": {int(k): v for k, v in
                                                     sound["head_dims"].items()},
            "loss_rel": loss_rel, "norm_rel": norm_rel, "runs": runs, "one": one}


def _train_tp_kernels(results: dict) -> None:
    """Phase 6e's kernels at a tp rank's training shapes: the attention
    forward with its lse (judged, its lse checked, timed beside SDPA) and
    the backward (judged, timed beside SDPA's backward, with its bound) at
    TRAIN_TP_ATTN_SHAPES; split3's forward kernel (judged, timed, with its
    bound) and its autograd.Function (judged and timed) at
    TRAIN_TP_SPLIT3_SHAPES; the readings kept under "tp_train_shapes"."""
    from psd_tpu_torch.ops import attention, split3
    from psd_tpu_torch.testing import ATTN_LSE_BAND, attention_judge, split3_judge

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(43)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape in TRAIN_TP_ATTN_SHAPES:
        B, S, H, D = shape
        q, k, v, dout = (randn(*shape) for _ in range(4))
        lse_abs = _check_lse(q, k, v, ATTN_LSE_BAND)
        _compare("attention", shape + ("lse",),
                 lambda: attention.attention_fwd(q, k, v, return_lse=True),
                 lambda: (attention.attention_reference(q, k, v),
                          attention.lse_reference(q, k, D ** -0.5)), results,
                 (4.0 * B * H * S * S * D, 4 * B * S * H * D * 2 + B * H * S * 4),
                 fn_library=lambda: _sdpa(q, k, v), extra={"lse_max_abs": lse_abs},
                 judge=lambda a, b: attention_judge(a[0], b[0]),
                 note={"exp2_ms_at_sfu_rate": B * H * S * S / sfu_exp2_per_s() * 1e3},
                 key="tp_train_shapes")
        entry = _attention_bwd_reading(shape, q, k, v, dout)
        results["attention_bwd"].setdefault("tp_train_shapes", []).append(entry)
        del q, k, v, dout
        torch.cuda.empty_cache()
    d1 = _delta(1.0)  # δ as the model passes it, in device memory
    for shape in TRAIN_TP_SPLIT3_SHAPES:
        B, S, H, D = shape
        q, banks = randn(*shape), [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", shape, lambda: split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, d1, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2),
                 judge=split3_judge, key="tp_train_shapes",
                 note={"device_ms": graph_ms(lambda: split3.split3_fwd(q, *banks, d1, 0.1,
                                                                       0.9))})
        _check_split3_autograd(randn, shape)
    torch.cuda.empty_cache()


def phase_train_tp(card: str, trained: dict, fault: bool = False) -> dict:
    """Phase 6e alone (6d runs it after --dp 2's step, in that launch): two
    ranks on cuda:0 over gloo; with `fault`, the planted faults its module
    bands were set against run after the sound step, and the checks are
    printed, not enforced. Then the kernels at the tp training shapes."""
    import shutil

    work = ROOT / "build" / "psd_tpu_torch" / "train_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    per_step = {k: v // TRAIN_STEPS for k, v in trained["counts"].items()}
    run = _torchrun(work, "tp_gloo", 2, kind="train_tp", backend="gloo",
                    faults=list(TRAIN_TP_FAULTS) if fault else [])
    if run["rc"] != 0 or not all(run["ranks"]):
        _ranks_failed("train_tp", "tp_gloo", run)
        raise SystemExit(f"chip_smoke.py: train tp did not run to its end (rc {run['rc']})")
    log(f"[train_tp] torchrun wall {run['wall']:.1f} s")
    out = _check_train_tp(card, run["ranks"], per_step, strict=not fault)
    _train_tp_kernels({"attention_bwd": {}})
    shutil.rmtree(work, ignore_errors=True)
    return out


def phase_train_ranks(card: str, trained: dict, fault: bool = False,
                      results: dict = None) -> dict:
    """The train CLI across ranks (phase 6d), one step each at a global
    batch of 32: a one-process run, the reference (its launches against
    phase 6's per step, its post-step parameters from the state it returns,
    no checkpoint written); one rank on NCCL at --dp 1 in this process,
    equal to it bit for bit; then torchrun's two ranks on cuda:0 over gloo
    at --dp 2 and at --fsdp 2, each against the reference (loss, grad norm,
    the parameters' update, each rank's launches), rank 0's checkpoint of
    --dp 2 read by the infer CLI, --fsdp 2's checkpoint its parameters
    alone (`_params_snapshot`). One launch runs --dp 2, then phase 6e, the
    tp train step (`_train_tp_rank`), then --fsdp 2 (the spec's `then`),
    each rank's state freed between them; 6e's checks follow --dp 2's, its
    kernels at the tp training shapes the phase's end (kept in `results`).
    `fault` runs the planted fault its bands were set against (every rank
    skipping the gradient average) and stops there."""
    import shutil
    from unittest import mock

    import numpy as np

    from psd_tpu_torch.pipelines import infer, train
    from psd_tpu_torch.train.checkpoint import CheckpointManager

    work = ROOT / "build" / "psd_tpu_torch" / "train_ranks"
    shutil.rmtree(work, ignore_errors=True)
    _write_tree(work / "data")
    cfg_path = ROOT / "configs" / "train_ip.yaml"
    base = ["--config", str(cfg_path), f"dataset.dataset_path={work / 'data'}", *RANKS_ARGS]
    per_step = {k: v // TRAIN_STEPS for k, v in trained["counts"].items()}

    def launches(steps, captured=False):
        """The steps and one encoded batch each (the encoder's mid-block
        attention). `captured`: the one-process CLI's compiled step, whose
        first step's warm-up and capture each launch a step's kernels on
        the host and whose replays none (the ranks' steps run op by op)."""
        n = min(steps, 1) * 2 if captured else steps
        return {k: per_step[k] * n + (steps if k == "attention" else 0) for k in per_step}

    want = launches(RANKS_STEPS)
    want0 = launches(RANKS_STEPS, captured=True)

    def ranks_run(tag, nproc, argv, **spec):
        run = _torchrun(work, tag, nproc, argv=argv, **spec)
        run["out"] = Path(argv[argv.index("--output-dir") + 1])
        return run

    def rank_lines(tag, run):
        for r in run["ranks"]:
            step = r["steps_s"][-1]
            comm = (f"its time in collectives not measured ({r['backend']})"
                    if r["comm_s"] is None else
                    f"{r['comm_s'][-1]:.4f} s in {r['backend']} collectives "
                    f"({r['comm_s'][-1] / step:.3f} of it)")
            log(f"[train_ranks] {tag} rank {r['rank']}/{r['world']} on {r['device']}: steps "
                f"{[round(x, 4) for x in r['steps_s']]} s (synced), the last {comm}; phases "
                f"{ {k: [round(x, 4) for x in v] for k, v in r['laps'].items()} }; main() wall "
                f"{r['wall']:.3f} s; peak {r['peak_gib']:.2f} GiB; launches {r['counts']}, "
                f"by head dim {r['head_dims']}; FSDP2 {r['sharded']}; on {card}")

    # the reference: the one-process run, its initial parameters kept on the
    # host as the CLI built them and its post-step parameters copied from
    # the state it returns (its checkpoint is not written: the CLI's
    # checkpoint without a process group is phase 6b's)
    start = {}
    make_state = train.create_train_state

    def keeping(model, **kw):
        start.update({n: p.detach().to("cpu", copy=True)
                      for n, p in model.core.named_parameters()})
        return make_state(model, **kw)

    def argv_for(tag):
        return base + ["--dp", "1", "--output-dir", str(work / tag)]

    torch.cuda.reset_peak_memory_stats()
    train.create_train_state = keeping
    try:
        with mock.patch.object(CheckpointManager, "save", lambda self, step, state: False):
            r0, counts0, dims0, wall0 = _counted(train.main, argv_for("one"))
    finally:
        train.create_train_state = make_state
    peak0 = torch.cuda.max_memory_allocated() / 2**30
    laps0 = r0["laps"]
    after = {n: p.detach().to("cpu", copy=True)
             for n, p in r0["state"].model.core.named_parameters()}
    del r0
    gc.collect()
    torch.cuda.empty_cache()
    ref = _logged(work / "one")
    log(f"[train_ranks] one process, global batch 32 (the reference): main() wall {wall0:.3f} "
        f"s; train_step {[round(x, 4) for x in laps0['train_step']]} s (no sync); losses "
        f"{[r['loss'] for r in ref]}, grad norms {[r['grad_norm'] for r in ref]}; launches "
        f"{counts0}; peak {peak0:.2f} GiB; on {card}")
    if counts0 != want0 or [r["step"] for r in ref] != list(range(1, RANKS_STEPS + 1)) \
            or (work / "one" / "checkpoints" / str(RANKS_STEPS)).exists():
        raise SystemExit(f"chip_smoke.py: the one-process run launched {counts0}, not {want0}, "
                         f"logged steps {[r['step'] for r in ref]} or wrote a checkpoint")

    # one rank on NCCL at --dp 1, the production backend: the reference bit
    # for bit (the same rows; the average over one rank is the identity)
    run = _nccl_rank_here(work, "dp1_nccl", argv=argv_for("dp1"))
    if run["rc"] != 0 or not all(run["ranks"]):
        _ranks_failed("train_ranks", "dp1_nccl", run)
        raise SystemExit(f"chip_smoke.py: --dp 1 on NCCL did not run to its end (rc {run['rc']})")
    got = _logged(work / "dp1")
    post = _params(work / "dp1" / "checkpoints" / str(RANKS_STEPS))
    reference = run["ranks"][0]
    rank_lines("--dp 1, one rank on NCCL", run)
    nccl_checks = {
        "losses equal the one process's": [r["loss"] for r in got] == [r["loss"] for r in ref],
        "grad norms equal": [r["grad_norm"] for r in got] == [r["grad_norm"] for r in ref],
        "post-step parameters equal, bit for bit": sorted(post) == sorted(after) == sorted(
            start) and all(torch.equal(post[k], after[k]) for k in after),
        f"launches {want}": reference["counts"] == want,
    }
    log(f"[train_ranks] --dp 1 on NCCL: wall {run['wall']:.1f} s (in this process); losses "
        f"{[r['loss'] for r in got]}, grad norms {[r['grad_norm'] for r in got]}; checks "
        f"{nccl_checks}")
    if not all(nccl_checks.values()):
        raise SystemExit(f"chip_smoke.py: --dp 1 on NCCL checks failed: "
                         f"{[k for k, v in nccl_checks.items() if not v]}")
    del post
    shutil.rmtree(work / "dp1", ignore_errors=True)

    def judge(tag, run):
        """The run's checks against the reference; → its readings."""
        steps = RANKS_STEPS
        if run["rc"] != 0 or not all(run["ranks"]):
            _ranks_failed("train_ranks", tag, run)
            raise SystemExit(f"chip_smoke.py: {tag} did not run to its end (rc {run['rc']})")
        got = _logged(run["out"])
        rel_post, rel_upd = _flat_rel(_params(run["out"] / "checkpoints" / str(steps)),
                                      after, start)
        loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got, ref)]
        norm_rel = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                    for a, b in zip(got, ref)]
        ranks, want = run["ranks"], launches(steps)
        checks = {
            f"{steps} steps logged by rank 0": [r["step"] for r in got] == list(
                range(1, steps + 1)),
            f"losses within rtol {RANKS_LOSS_RTOL:g}": len(loss_rel) == steps
                and max(loss_rel) <= RANKS_LOSS_RTOL,
            f"grad norms within rtol {RANKS_NORM_RTOL:g}": len(norm_rel) == steps
                and max(norm_rel) <= RANKS_NORM_RTOL,
            f"update difference ≤ {RANKS_UPDATE_BAND:g}": rel_upd <= RANKS_UPDATE_BAND,
            f"checkpoint step {steps} only": sorted(
                p.name for p in (run["out"] / "checkpoints").iterdir()) == [str(steps)],
            f"each rank's launches {want}": all(r["counts"] == want for r in ranks),
        }
        rank_lines(tag, run)
        log(f"[train_ranks] {tag}: torchrun wall {run['wall']:.1f} s, rc {run['rc']}; losses "
            f"{[r['loss'] for r in got]} (rel {loss_rel}), grad norms "
            f"{[r['grad_norm'] for r in got]} (rel {norm_rel}); post-step parameters rel L2 "
            f"{rel_post:.3e}, over the reference's update {rel_upd:.3e}")
        log(f"[train_ranks] {tag} checks {checks}")
        if not all(checks.values()):
            bad = [k for k, v in checks.items() if not v]
            raise SystemExit(f"chip_smoke.py: {tag} checks failed: {bad}\n"
                             + "\n".join(run["tail"]))
        return {"loss_rel": loss_rel, "norm_rel": norm_rel, "rel_post": rel_post,
                "rel_update": rel_upd, "ranks": ranks}

    if fault:
        run = ranks_run("fault", 2, base + ["--dp", "2", "--output-dir", str(work / "fault")],
                        backend="gloo", fault="no_average")
        if run["rc"] != 0:
            _ranks_failed("train_ranks", "planted fault", run)
        got = _logged(run["out"])
        rel_post, rel_upd = _flat_rel(_params(run["out"] / "checkpoints" / str(RANKS_STEPS)),
                                      after, start)
        log(f"[train_ranks] planted fault (no gradient average), --dp 2 over gloo: losses "
            f"{[r['loss'] for r in got]}, grad norms {[r['grad_norm'] for r in got]} against "
            f"{[r['grad_norm'] for r in ref]}; post-step parameters rel L2 {rel_post:.3e}, over "
            f"the reference's update {rel_upd:.3e}")
        shutil.rmtree(work, ignore_errors=True)
        return {}

    readings = {}
    fsdp_out = work / "fsdp2"
    run = ranks_run("dp2_gloo", 2, base + ["--dp", "2", "--output-dir", str(work / "dp2")],
                    backend="gloo", tp=True,
                    then={"argv": base + ["--fsdp", "2", "--output-dir", str(fsdp_out)],
                          "params_only": True})
    readings["dp2_gloo"] = judge("--dp 2, two ranks on cuda:0 over gloo", run)
    r0 = run["ranks"][0]
    if "t_worker" in r0 and "then" in r0:
        (w0, w1), (m0, m1), (p0, p1) = r0["t_worker"], r0["t_main"], r0["t_tp"]
        f0, f1 = r0["then"]["t_main"]
        log(f"[train_ranks] the launch, rank 0 (s): torchrun's start to its worker "
            f"{w0 - run['t_spawn']:.1f}, to --dp 2's main() {m0 - w0:.1f}, main() {m1 - m0:.1f}, "
            f"to 6e {p0 - m1:.1f}, 6e {p1 - p0:.1f}, to --fsdp 2's main() {f0 - p1:.1f}, main() "
            f"{f1 - f0:.1f}, to its worker's end {w1 - f1:.1f}, to torchrun's exit "
            f"{run['t_exit'] - w1:.1f}; {run['wall']:.1f} in all")
    counts = r0["counts"]
    head_dims = run["ranks"][0]["head_dims"]
    tp = _check_train_tp(card, run["ranks"], per_step)

    # rank 0's checkpoint read by the infer CLI, on its EMA
    png = sorted((work / "data" / "val" / "Mayo_2").iterdir())[0]
    r3 = infer.main(["--config", str(cfg_path), "--structure-image", str(png), "--checkpoint",
                     str(work / "dp2" / "checkpoints"), "--ema", "--output-dir",
                     str(work / "infer"), *TRAIN_CLI_INFER])
    images = r3["images"]
    del r3
    gc.collect()
    torch.cuda.empty_cache()
    infer_ok = images.shape == (TRAIN_CLI_GRID, 256, 256, 3) and bool(
        np.isfinite(images).all()) and images.min() >= 0.0 and images.max() <= 1.0
    log(f"[train_ranks] infer --checkpoint <rank 0's> --ema: images {images.shape} finite in "
        f"[0, 1]: {infer_ok}")
    if not infer_ok:
        raise SystemExit("chip_smoke.py: the infer CLI did not read rank 0's checkpoint")
    shutil.rmtree(work / "dp2", ignore_errors=True)

    # --fsdp 2 ran in --dp 2's launch, after 6e (one process start a launch)
    run = dict(run, ranks=[r and r["then"] for r in run["ranks"]], out=fsdp_out)
    readings["fsdp2_gloo"] = judge("--fsdp 2, two ranks on cuda:0 over gloo (in --dp 2's launch)",
                                   run)
    if not all(r["sharded"] for r in run["ranks"]):
        raise SystemExit("chip_smoke.py: the --fsdp 2 run was not under FSDP2")
    shutil.rmtree(run["out"], ignore_errors=True)

    _check_rank_shapes()
    _train_tp_kernels(results if results is not None else {"attention_bwd": {}})
    shutil.rmtree(work, ignore_errors=True)
    return {"counts": counts, "head_dims": head_dims, "readings": readings,
            "one_process": {"counts": counts0, "wall": wall0, "peak_gib": peak0},
            "nccl": {"counts": reference["counts"], "wall": reference["wall"],
                     "peak_gib": reference["peak_gib"]}, "tp": tp}


# ---- quality gates ------------------------------------------------------------------
def _check_gates_shapes() -> None:
    """Each serving kernel of the gates' path against its plain version by
    its judge at GATES_* (batch 8 and 4 at 256²); not timed, not counted.
    Synth-train's batch-8 training shapes are phase 6's accumulation
    check's, judged there."""
    from psd_tpu_torch.ops import split3
    from psd_tpu_torch.testing import split3_judge

    _judge_shapes("gates", GATES_ATTN_SHAPES, GATES_LN_SHAPES, GATES_GN_SHAPES, seed=29)
    g = torch.Generator(device="cuda").manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    d1 = _delta(1.0)
    for (B, S, H, D) in GATES_SPLIT3_SHAPES:
        q, banks = randn(B, S, H, D), [randn(B, 16, H, D) for _ in range(6)]
        ok, text, _ = split3_judge(split3.split3_fwd(q, *banks, d1, 0.1, 0.9),
                                   split3.split3_reference(q, *banks, d1, 0.1, 0.9))
        log(f"[gates] split3 {(B, S, H, D)}: {text} {'ok' if ok else 'FAIL'} (not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: split3 {(B, S, H, D)} disagrees with its plain "
                             "version")
    torch.cuda.empty_cache()


def _finite_numbers(obj, path="") -> list:
    """The paths of the numbers in a gate's JSON that are not finite."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in _finite_numbers(v, f"{path}/{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj) for p in _finite_numbers(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not math.isfinite(obj):
        return [path]
    return []


def _gate_launches(rec: dict, batch: int, size: int, decode: bool) -> tuple:
    """(the host launches of a variant's first calls, counted from 0, and 2
    × route_launches of its knobs: warm-up and capture of each program)."""
    from psd_tpu_torch.testing import route_launches

    m, v = rec["model"], rec["variant"]
    want = route_launches(m.core_cfg, m.vae_cfg, batch, size,
                          *_full_shallow(v["steps"], v["stride"], v["cache_mode"]), decode=decode)
    got = {k: rec["launches"].get(k, 0) for k in SERVE_KERNELS}
    return got, {k: 2 * n for k, n in want.items()}


def phase_gates(card: str) -> dict:
    """The port's quality gates on the card (phase 7), each through its
    script's main() in this process at configs' width (`Config()`, the
    SD-v1.4 UNet): (a) the stride gate (GATES_STRIDE: synth-train, then the
    exact and converged-DPM baselines and three variants at 512²), (b) the
    distribution gate (GATES_DIST: R + 1 exact sets, the variants' sets,
    FID and CMMD on the random backbones), (c) the int8 gate at its
    defaults, then its decode mode at 512². Synth-train runs once: (b) asks
    for the same run as (a) (Config(), GATES_TRAIN_STEPS steps at batch 8,
    the same seeds) and takes its weights, and (c) takes them in place of
    `fast_init`'s host fill of the core (held bit for bit against psd_tpu's
    on the CPU; its fill of the whole AutoencoderKL runs). Checks: every
    number in every row finite; every stride variant's latent_rel_error
    above 0; the distribution gate's int8 set on the exact set's latents
    bit for bit with its images apart; the int8 gate's images apart; the
    signal check above the noise floor; synth-train's loss finite at every
    printed step; the exact program's latents equal to an eager run of the
    same inputs bit for bit; each variant's host launches, from 0, 2 ×
    route_launches of its knobs (its programs' warm-up and capture) and
    each int8 run's its models'; the kernels at the gates' shapes against
    their plain versions (GATES_*). Prints the three tables, each
    program's warm-up and capture seconds, the phase's peak memory and each
    gate's wall time. The counts of the gates' runs (each from 0, the
    judges apart) are the path "gates"."""
    from unittest import mock

    import numpy as np

    from psd_tpu_torch.core.mode import eager
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.testing import route_launches

    _check_gates_shapes()
    stride, dist, int8 = (_load_script(f"torch_check_{n}") for n in (
        "stride_quality", "turbo_distribution", "int8_quality"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, traces, train_logs, tables, counts, built = {}, {}, {}, {}, {}, {}
    total = Counter()
    trained = {"calls": 0}
    synth_train = stride.synth_train

    def synth_once(cfg, steps, **kw):
        """(a)'s synth-train, and its result again for the same request."""
        request = (cfg, steps, {k: str(v) for k, v in kw.items() if k != "log"})
        trained["calls"] += 1
        if "out" not in trained:
            trained["request"], trained["out"] = request, synth_train(cfg, steps, **kw)
        elif request != trained["request"]:
            raise SystemExit(f"chip_smoke.py: the gates asked for two synth-train runs: "
                             f"{trained['request']} and {request}")
        return trained["out"]

    def run(name, fn, *args):
        """A gate's main(), its launches from 0: the scripts' records set
        the counts to 0 again before each variant and keep what they held
        (`earlier`), so the run's are theirs plus the last read."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 1)
        counts[name] = dict(kernels.launch_counts)
        total.update(counts[name])
        return out

    with mock.patch.object(stride, "synth_train", synth_once), \
            mock.patch.object(dist, "synth_train", synth_once), \
            mock.patch.object(int8, "fast_init_core", lambda core_cfg: trained["out"][0]):
        for name, main, argv in (("stride", stride.main, GATES_STRIDE),
                                 ("distribution", dist.main, GATES_DIST)):
            traces[name], train_logs[name] = [], []
            tables[name] = run(name, main, argv, traces[name], train_logs[name])
            for rec in traces[name]:
                total.update(rec["earlier"])
        for name, argv in zip(("int8", "int8_vae"), GATES_INT8):
            built[name] = []
            tables[name] = run(name, int8.main, argv, built[name])
    synth_calls = trained.pop("calls")
    trained.clear()
    peak = torch.cuda.max_memory_allocated() / 2**30
    path_kernels = SERVE_KERNELS + ("attention_bwd",)

    for name in ("stride", "distribution", "int8", "int8_vae"):
        log(f"[gates] {name} table: {json.dumps(tables[name])}")
    for name in ("stride", "distribution"):
        for rec in traces[name]:
            progs = ", ".join(f"{k} warm-up {w:.3f} s capture {c:.3f} s instantiation {i:.3f} s"
                              for k, w, c, i in rec["programs"])
            log(f"[gates] {name} {rec['name']}: {progs}")
    log(f"[gates] synth-train (the stride gate's; the distribution gate and the int8 gate's "
        f"core take its weights): {train_logs['stride']}")
    log(f"[gates] walls {walls} s; peak allocated {peak:.3f} GiB; launches {dict(total)}; on "
        f"{card}")

    a, b = tables["stride"], tables["distribution"]
    sets = {rec["name"]: rec["first"] for rec in traces["distribution"]}
    int8_gap = float(np.abs(sets["int8"]["images"] - sets["exact"]["images"]).max())
    log(f"[gates] the distribution gate's int8 set against the exact set, batch 0: latents "
        f"equal {np.array_equal(sets['int8']['latents'], sets['exact']['latents'])}, images max "
        f"|Δ| {int8_gap:.4e}")
    checks = {"every number finite": not any(_finite_numbers(t) for t in tables.values()),
              "every stride variant apart from exact":
                  all(r["latent_rel_error"] > 0 for r in a["rows"]),
              "the distribution gate's int8 set: the exact latents bit for bit, the images "
              "apart": np.array_equal(sets["int8"]["latents"], sets["exact"]["latents"])
                  and int8_gap > 0,
              "the int8 gate's images apart": tables["int8"]["max_abs_diff"] > 0
                  and tables["int8_vae"]["max_abs_diff"] > 0,
              "signal above the noise floor":
                  b["signal_check_vs_uniform_noise"]["fid"] > b["noise_floor_fresh_seeds"]["fid"]
                  and b["signal_check_vs_uniform_noise"]["cmmd"]
                  > b["noise_floor_fresh_seeds"]["cmmd"],
              "synth-train once, its losses finite": synth_calls == 2
                  and not train_logs["distribution"] and len(train_logs["stride"]) >= 2
                  and all(math.isfinite(loss) for _, loss, _ in train_logs["stride"]),
              f"every kernel of the path launched {path_kernels}":
                  all(total.get(k, 0) > 0 for k in path_kernels)}
    log(f"[gates] signal {b['signal_check_vs_uniform_noise']} against the floor "
        f"{b['noise_floor_fresh_seeds']}")
    batch_a, size_a = int(GATES_STRIDE[3]), int(GATES_STRIDE[1])
    batch_b, size_b = int(GATES_DIST[3]), int(GATES_DIST[1])
    for name, batch, size, decode in (("stride", batch_a, size_a, False),
                                      ("distribution", batch_b, size_b, True)):
        for rec in traces[name]:
            got, want = _gate_launches(rec, batch, size, decode)
            checks[f"{name} {rec['name']} launches 2 x route_launches {want}"] = got == want
            if got != want:
                log(f"[gates] {name} {rec['name']}: launches {got} against {want}")
    # the int8 gate: each model's generate program (warm-up + capture); the
    # decode mode's two eager decoders
    steps_c, size_c, batch_c = 10, 256, 4
    want_c = Counter()
    for m in built["int8"]:
        want_c.update({k: 2 * n for k, n in route_launches(m.core_cfg, m.vae_cfg, batch_c, size_c,
                                                           steps_c).items()})
    want_d = Counter(attention=len(built["int8_vae"]))  # each decoder's mid-block attention
    for name, want in (("int8", want_c), ("int8_vae", want_d)):
        got = {k: counts[name].get(k, 0) for k in SERVE_KERNELS}
        checks[f"{name} launches {dict(want)}"] = got == {k: want[k] for k in SERVE_KERNELS}
    # the exact program's latents against an eager run of the same inputs
    exact = traces["stride"][0]
    with eager():
        again = exact["rerun"]()
    checks["the exact program's latents equal to eager, bit for bit"] = torch.equal(
        exact["output"], again)
    log(f"[gates] checks {checks}")
    del traces, exact, again, built, sets
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: gates checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"counts": {k: total.get(k, 0) for k in KERNELS}, "walls": walls, "peak_gib": peak,
            "checks": checks}


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
    weights = timed("weights", phase_weights, card)
    served = timed("serve", phase_serve, card, unet)
    scalars = timed("scalars", phase_scalars, card, served)
    turbo = timed("turbo", phase_turbo, card, served)
    inferred = timed("infer", phase_infer, card)
    levers = timed("unet levers", phase_unet_levers, card, turbo, results)
    served_dp = timed("serve ranks", phase_serve_ranks, card, served, results)
    served_tp = served_dp["tp"]
    timed("train kernels", phase_train_kernels, results)
    trained = timed("train", phase_train, card)
    train_cli = timed("train cli", phase_train_cli, card, trained)
    loop = timed("product loop", phase_product_loop, card, train_cli)
    ranks = timed("train ranks", phase_train_ranks, card, trained, False, results)
    trained_tp = ranks["tp"]
    gates = timed("gates", phase_gates, card)
    log(f"[done] seconds per phase {seconds}, {sum(seconds.values()):.1f} s in all")

    entries = []
    for name, (replaces, source) in KERNELS.items():
        r = results[name]
        by_path = {path: run["counts"][name] for path, run in
                   (("serve", served), ("scalars", scalars), ("turbo", turbo),
                    ("infer", inferred), ("train", trained),
                    ("train_graph", {"counts": trained["graph_counts"]}),
                    ("train_cli", train_cli), ("op", op),
                    ("augment", loop["augment"]), ("evaluate", loop["evaluate"]),
                    ("train_dp", ranks), ("serve_dp", served_dp), ("levers", levers),
                    ("serve_tp", served_tp), ("train_tp", trained_tp), ("weights", weights),
                    ("weights_cli", weights["cli"]), ("gates", gates))}
        # serve, turbo and levers count host launches (the eager warm-up and the
        # capture of their program); what each replay launches is apart
        by_replay = {path: run["replay_launches"].get(name, 0)
                     for path, run in (("serve", served), ("turbo", turbo), ("levers", levers))}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "launches_per_replay": by_replay,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": _bound_by(r),
                 "library_ms": r["library_ms"], "shapes": r["shapes"]}
        for extra in ("levers_shapes", "tp_shapes", "tp_train_shapes"):
            if extra in r:
                entry[extra] = r[extra]
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
                (("serve", served), ("scalars", scalars), ("turbo", turbo),
                 ("infer", inferred), ("train", trained),
                 ("train_graph", {"head_dims": trained["graph_head_dims"]}),
                 ("train_cli", train_cli),
                 ("augment", loop["augment"]), ("evaluate", loop["evaluate"]),
                 ("train_dp", ranks), ("serve_dp", served_dp), ("levers", levers),
                 ("serve_tp", served_tp), ("train_tp", trained_tp), ("weights", weights),
                 ("weights_cli", weights["cli"]))}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
