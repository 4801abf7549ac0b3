#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile psd_tpu_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
               per source, all at once.
  3. kernels — each serving kernel against its plain PyTorch version at
               every shape the 512², batch-8 serving path gives it (bf16,
               seeded inputs): max abs/rel error against a stated band;
               kernel, plain and (where one PyTorch call computes the same
               function) library time (CUDA events, median of 10 after
               warm-up); and the bound, the least time the card could take
               (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s bf16,
               whichever is larger).
  4. unet    — one SD-scale UNet eps (split3, seeded flax-style init, bf16,
               latents (8, 64, 64, 4), 48 tokens, δ=1) on the kernels and
               with the plain versions forced: relative error; then eps time
               with gn_proj on and off in 10 alternating pairs (host clock:
               wall and enqueue, medians and quartiles).
  5. serve   — a GenerationServer over the SD-scale DADD at 512², 50 DDIM
               steps, max_batch 8, steer 1.0 answers 8 requests; images are
               checked and every serving kernel's launch count must be > 0.
  6. train   — the attention backward kernel against autograd through the
               plain version, and split3's autograd.Function against the
               plain version, at the training shapes; then the SD-scale
               train step of configs/train_ip.yaml (256², batch 64, fp32
               masters, bf16 compute, gradient checkpointing, AdamW in two
               LR groups, EMA from step 0) takes 3 steps on seeded random
               pre-encoded batches; loss and gradients on the kernels are
               held against the plain versions with the same draws, the
               flattened gradient and, on their own, the q/k/v weight
               gradients of the self-attention sites the kernel serves.
The line before the last is a JSON object with one entry per kernel:
`launches` counts the launches of the main-path runs (phases 5 and 6, each
with the counts set to 0 just before it; `launches_by_path` splits them),
`max_abs_err` is the largest over the kernel's shapes, `ms`, `plain_ms`,
`library_ms` and `bound_ms` sum one call at each of its main-path shapes.
The last line is the device JSON. Imports nothing of JAX.
"""

from __future__ import annotations

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

# bf16 band for kernel-vs-plain: both round their inputs, probabilities and
# outputs to bf16 at different points (2^-8 relative each), and sum in
# different orders.
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
# the attn1 sites on the attention kernel at 256² (32×32 latents, S = 1024)
ATTN1_LEAF = re.compile(r"unet\.(down_blocks_0|up_blocks_3)_attentions_\d+\.transformer_blocks_0"
                        r"\.attn1\.to_[qkv]\.weight")
GN_AB_PAIRS = 10

# kernel → (TPU kernel it replaces as file:line, CUDA source)
KERNELS = {
    "attention": ("psd_tpu/ops/spattn.py:36", "psd_tpu_torch/csrc/attention.cu"),
    "attention_bwd": ("psd_tpu/ops/flash.py:121", "psd_tpu_torch/csrc/attention_bwd.cu"),
    "split3": ("psd_tpu/ops/split3.py:29", "psd_tpu_torch/csrc/split3.cu"),
    "ln_proj": ("psd_tpu/ops/geglu.py:178", "psd_tpu_torch/csrc/ln_proj.cu"),
    "ln_geglu": ("psd_tpu/ops/geglu.py:73", "psd_tpu_torch/csrc/ln_geglu.cu"),
    "gn_proj": ("psd_tpu/ops/gnproj.py:44", "psd_tpu_torch/csrc/gn_proj.cu"),
}
SERVE_KERNELS = ("attention", "split3", "ln_proj", "ln_geglu", "gn_proj")
# the attention kernel also takes the stock Pallas flash kernel's forward;
# attention_bwd is that kernel's dq/dkv backward
ALSO_REPLACES = {"attention": "psd_tpu/ops/flash.py:121 (jax.experimental.pallas.ops."
                              "tpu.flash_attention, forward)",
                 "attention_bwd": "jax.experimental.pallas.ops.tpu.flash_attention "
                                  "(dq and dkv backward kernels, configured at "
                                  "psd_tpu/ops/flash.py:104-121)"}

# shapes on the 512², batch-8 main path (SD-v1.4 UNet, 8 heads; VAE mid)
ATTN_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 4096, 1, 512)]
SPLIT3_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
LN_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]
GN_SHAPES = [(8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (8, 64, 1280)]
# a generate call of batch 1 or 3 at 512²: B·S % 128 == 64 at the mid block,
# the kernel's half-full last row tile (checked, not timed)
GN_EDGE_SHAPES = [(1, 64, 1280), (3, 64, 1280), (3, 192, 640)]
# training: 256², batch 64 (configs/train_ip.yaml); the 512² routes too
ATTN_BWD_SHAPES = [(64, 1024, 8, 40), (8, 4096, 8, 40), (8, 1024, 8, 80)]
SPLIT3_TRAIN_SHAPES = [(64, 1024, 8, 40), (64, 256, 8, 80)]
TRAIN_STEPS, TRAIN_BATCH = 3, 64

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores and
# HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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
def phase_build() -> None:
    from psd_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 0:.2f} s)")


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


def bound(flops: float, nbytes: float):
    """(least ms, "bytes" | "operations") for work of `flops` bf16 FLOPs
    moving `nbytes` bytes (each input read once, each output written once)."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(name, shape, fn_kernel, fn_plain, results, work, fn_library=None):
    """`work` = (FLOPs, bytes) of the function at this shape."""
    out_k = fn_kernel()
    out_p = fn_plain()
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    abs_err = rel_err = 0.0
    ok = True
    for a, b in zip(outs_k, outs_p):
        d = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(ref, 1e-12))
        ok = ok and bool(torch.isfinite(a).all()) and d <= ATOL + RTOL * ref
    del out_k, out_p, outs_k, outs_p
    ms_k = time_ms(fn_kernel)
    ms_p = time_ms(fn_plain)
    ms_l = time_ms(fn_library) if fn_library is not None else None
    b_ms, b_by = bound(*work)
    log(f"[kernel] {name:13s} {str(shape):28s} max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
        f"band {ATOL:g}+{RTOL:g}*max|ref| {'ok' if ok else 'FAIL'}  "
        f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms  library "
        f"{'none' if ms_l is None else f'{ms_l:.4f} ms'}  bound {b_ms:.4f} ms ({b_by})")
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": None, "bound_ms": 0.0, "shapes": []})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    r["ms"] += ms_k
    r["plain_ms"] += ms_p
    if ms_l is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + ms_l
    r["bound_ms"] += b_ms
    r["shapes"].append({"shape": list(shape), "max_abs_err": abs_err,
                        "max_rel_err": rel_err, "ms": ms_k, "plain_ms": ms_p,
                        "library_ms": ms_l, "bound_ms": b_ms, "bound_by": b_by,
                        "flops": work[0], "bytes": work[1]})
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


def phase_kernels() -> dict:
    from psd_tpu_torch.ops import attention, geglu, gnproj, split3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results: dict = {}
    for shape in ATTN_SHAPES:
        B, S, H, D = shape
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        _compare("attention", shape,
                 lambda: attention.attention_fwd(q, k, v),
                 lambda: attention.attention_reference(q, k, v), results,
                 (4.0 * B * H * S * S * D, 4 * B * S * H * D * 2),
                 fn_library=lambda: _sdpa(q, k, v))
        del q, k, v
    for (B, S, H, D) in SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, 1.0, 0.1, 0.9), results,
                 (3 * 4.0 * B * H * S * 16 * D, (2 * B * S + 6 * B * 16) * H * D * 2))
    for (M, C) in LN_SHAPES:
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        for n_out in (3, 1):
            ws = tuple(randn(C, C, std=C ** -0.5) for _ in range(n_out))
            _compare("ln_proj", (M, C, n_out),
                     lambda: geglu.ln_proj_fwd(x, lw, lb, ws),
                     lambda: geglu.ln_proj_reference(x, lw, lb, ws), results,
                     (2.0 * M * C * C * n_out,
                      M * C * 2 + 2 * C * 4 + n_out * (C * C * 2 + M * C * 2)))
        w0 = randn(8 * C, C, std=C ** -0.5)
        b0 = randn(8 * C, std=0.02, dtype=torch.float32)
        _compare("ln_geglu", (M, C),
                 lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                 lambda: geglu.ln_geglu_reference(x, lw, lb, w0, b0), results,
                 (2.0 * M * C * 8 * C,
                  M * C * 2 + 2 * C * 4 + 8 * C * C * 2 + 8 * C * 4 + M * 4 * C * 2))
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
                  B * S * C * 2 * 2 + 2 * B * C * 4 + C * C * 2 + C * 4))
    for (B, S, C) in GN_EDGE_SHAPES:
        x = randn(B, S, C)
        gw = 1.0 + randn(B, C, std=0.1, dtype=torch.float32)
        gb = randn(B, C, std=0.1, dtype=torch.float32)
        w = randn(C, C, std=C ** -0.5)
        bias = randn(C, std=0.02, dtype=torch.float32)
        out = gnproj.gn_proj_fwd(x, gw, gb, w, bias).float()
        ref = gnproj.gn_proj_reference(x, gw, gb, w, bias).float()
        d, m = (out - ref).abs().max().item(), ref.abs().max().item()
        ok = bool(torch.isfinite(out).all()) and d <= ATOL + RTOL * m
        log(f"[kernel] gn_proj edge  {str((B, S, C)):28s} max_abs {d:.3e} "
            f"{'ok' if ok else 'FAIL'} (ragged last row tile; not timed)")
        if not ok:
            raise SystemExit(f"chip_smoke.py: gn_proj {(B, S, C)} disagrees with its plain version")
    return results


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
    if not ok or min(counts.values()) == 0:
        raise SystemExit("chip_smoke.py: UNet on the kernels disagrees with the plain "
                         "versions or skipped a kernel")
    del unet, out_k, out_p
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "eps_ms": ms_k, "eps_plain_ms": ms_p, "gn_proj_ab": ab}


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
def phase_serve(card: str) -> dict:
    import numpy as np

    from psd_tpu_torch.core.config import load_config
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
    feats = rng.standard_normal((batch, 257, 1024)).astype(np.float32)
    targets = np.linspace(0.0, 3.0, batch)

    server = GenerationServer(model, image_size=size, sampling_steps=steps,
                              steer_scale=1.0, max_batch=batch, max_wait_s=0.5)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    futures = [server.submit(feats[i], targets[i], 1.0, seed=i) for i in range(batch)]
    images = [f.result(timeout=900) for f in futures]
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    serve_counts = {k: counts[k] for k in SERVE_KERNELS}
    d512 = kernels.attention_head_dims[512]
    server.close()
    if server._worker.is_alive():
        raise SystemExit("chip_smoke.py: the server worker did not stop")

    checks = {
        "shape (512,512,3)": all(im.shape == (size, size, 3) for im in images),
        "finite": all(np.isfinite(im).all() for im in images),
        "in [0,1]": all(im.min() >= 0.0 and im.max() <= 1.0 for im in images),
        "targets differ": not np.allclose(images[0], images[-1], atol=1e-3),
        "all five serving kernels launched": min(serve_counts.values()) > 0,
        "attention saw D=512 (VAE)": d512 > 0,
    }
    log(f"[serve] {batch} requests, {size}px, {steps} DDIM steps, steer 1.0, "
        f"max_batch {batch}: wall {wall:.3f} s, {batch / wall:.4f} img/s on {card}")
    log(f"[serve] launches {counts}; attention by head dim {dict(kernels.attention_head_dims)}")
    log(f"[serve] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: serve checks failed: {checks}")
    del server, model
    torch.cuda.empty_cache()
    return {"counts": counts, "wall_s": wall, "img_per_s": batch / wall}


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


def phase_train_kernels(results: dict) -> None:
    """The attention backward kernel and split3's autograd.Function at the
    training shapes, against autograd through their plain versions."""
    from psd_tpu_torch.ops import attention, split3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape in ATTN_BWD_SHAPES:
        B, S, H, D = shape
        q, k, v, dout = (randn(*shape) for _ in range(4))
        out, lse = attention.attention_fwd(q, k, v, return_lse=True)
        got = attention.attention_bwd(q, k, v, out, lse, dout)
        want = attention.attention_bwd_reference(q, k, v, dout)
        err = _grad_compare("attention_bwd", shape, ("dq", "dk", "dv"), got, want)
        del got, want

        def fwd_bwd_kernel():
            o, l_ = attention.attention_fwd(q, k, v, return_lse=True)
            return attention.attention_bwd(q, k, v, o, l_, dout)

        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

        def fwd_bwd_sdpa():
            return torch.autograd.grad(_sdpa(qg, kg, vg), (qg, kg, vg), dout)

        ms_k = time_ms(lambda: attention.attention_bwd(q, k, v, out, lse, dout), n=5)
        ms_p = time_ms(lambda: attention.attention_bwd_reference(q, k, v, dout), n=3, warmup=1)
        ms_fb = time_ms(fwd_bwd_kernel, n=5)
        ms_l = time_ms(fwd_bwd_sdpa, n=5)
        flops = 5 * 2.0 * B * H * S * S * D
        nbytes = 8 * B * S * H * D * 2 + B * H * S * 4
        b_ms, b_by = bound(flops, nbytes)
        log(f"[train] attention_bwd {shape}: kernel {ms_k:.4f} ms, plain (autograd through "
            f"the plain forward) {ms_p:.4f} ms, kernel fwd+bwd {ms_fb:.4f} ms, SDPA fwd+bwd "
            f"{ms_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        r = results.setdefault("attention_bwd", {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                                 "library_ms": 0.0, "bound_ms": 0.0,
                                                 "fwd_bwd_ms": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, val in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                         ("bound_ms", b_ms), ("fwd_bwd_ms", ms_fb)):
            r[key] += val
        r["shapes"].append({"shape": list(shape), "max_abs_err": err, "ms": ms_k,
                            "plain_ms": ms_p, "library_ms": ms_l, "fwd_bwd_ms": ms_fb,
                            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                            "bytes": nbytes})
        del q, k, v, dout, out, lse, qg, kg, vg
        torch.cuda.empty_cache()

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
    from psd_tpu_torch.core.mode import TRAINING_KERNELS, disable_kernels
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
        "ln_proj, ln_geglu, gn_proj not launched": max(
            counts["ln_proj"], counts["ln_geglu"], counts["gn_proj"]) == 0,
    }
    log(f"[train] {TRAIN_STEPS} steps at {size}², batch {B}: losses {losses}, grad norms {norms}; "
        f"step times {[round(t, 4) for t in times]} s; steady step {step_s:.4f} s = "
        f"{B / step_s:.2f} img/s on {card}; peak memory {peak_gb:.2f} GiB")
    log(f"[train] launches over {TRAIN_STEPS} steps {counts}")
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
        loss, _ = model.train_loss(batch, draws=draws)
        loss.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                          for p in params])
        for p in params:
            p.grad = None
        return loss.detach(), flat

    leaves = [i for i, (n, _) in enumerate(model.core.named_parameters())
              if ATTN1_LEAF.fullmatch(n)]
    if len(leaves) != 15:
        raise SystemExit(f"chip_smoke.py: expected 15 attn1 q/k/v leaves, found {len(leaves)}")
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
    del grad_k, grad_p, model, state, step
    torch.cuda.empty_cache()
    return {"counts": counts, "step_s": step_s, "img_per_s": B / step_s, "peak_gb": peak_gb,
            "rel_loss": rel_loss, "rel_grad": rel_grad, "rel_attn1_leaf": rel_leaf}


def main() -> int:
    card = phase_device()
    phase_build()
    results = phase_kernels()
    phase_unet()
    served = phase_serve(card)
    phase_train_kernels(results)
    trained = phase_train(card)

    entries = []
    for name, (replaces, source) in KERNELS.items():
        r = results[name]
        by_path = {"serve": served["counts"][name], "train": trained["counts"][name]}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": _bound_by(r),
                 "library_ms": r["library_ms"], "shapes": r["shapes"]}
        if "fwd_bwd_ms" in r:
            entry["fwd_bwd_ms"] = r["fwd_bwd_ms"]
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
