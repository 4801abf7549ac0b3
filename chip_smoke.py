#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile psd_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels — each hand-written kernel against its plain PyTorch version at
               every shape the 512², batch-8 serving path gives it (bf16,
               seeded inputs): max abs/rel error against a stated band, and
               kernel vs plain time (CUDA events, median of 10 after warm-up).
  4. unet    — one SD-scale UNet eps (split3, seeded flax-style init, bf16,
               latents (8, 64, 64, 4), 48 tokens, δ=1) on the kernels and
               with the plain versions forced: relative error.
  5. serve   — a GenerationServer over the SD-scale DADD at 512², 50 DDIM
               steps, max_batch 8, steer 1.0 answers 8 requests; images are
               checked and every kernel's launch count must be > 0.
The line before the last is a JSON object with one entry per kernel:
`launches` counts the serve phase's launches, `max_abs_err` is the largest
over the kernel's shapes, `ms`/`plain_ms` sum one call at each of its
main-path shapes. The last line is the device JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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

# kernel → (TPU kernel it replaces as file:line, CUDA source)
KERNELS = {
    "attention": ("psd_tpu/ops/spattn.py:36", "psd_tpu_torch/csrc/attention.cu"),
    "split3": ("psd_tpu/ops/split3.py:29", "psd_tpu_torch/csrc/split3.cu"),
    "ln_proj": ("psd_tpu/ops/geglu.py:178", "psd_tpu_torch/csrc/ln_proj.cu"),
    "ln_geglu": ("psd_tpu/ops/geglu.py:73", "psd_tpu_torch/csrc/ln_geglu.cu"),
}
# the attention kernel also takes the stock Pallas flash kernel's forward
ALSO_REPLACES = {"attention": "psd_tpu/ops/flash.py:121 (jax.experimental.pallas.ops."
                              "tpu.flash_attention, forward)"}

# shapes on the 512², batch-8 main path (SD-v1.4 UNet, 8 heads; VAE mid)
ATTN_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 4096, 1, 512)]
SPLIT3_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
LN_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]


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


def _compare(name, shape, fn_kernel, fn_plain, results):
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
    ms_k = time_ms(fn_kernel)
    ms_p = time_ms(fn_plain)
    log(f"[kernel] {name:9s} {str(shape):28s} max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
        f"band {ATOL:g}+{RTOL:g}*max|ref| {'ok' if ok else 'FAIL'}  "
        f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms")
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "shapes": []})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    r["ms"] += ms_k
    r["plain_ms"] += ms_p
    r["shapes"].append({"shape": list(shape), "max_abs_err": abs_err,
                        "max_rel_err": rel_err, "ms": ms_k, "plain_ms": ms_p})
    if not ok:
        raise SystemExit(f"chip_smoke.py: {name} {shape} disagrees with its plain version")


def phase_kernels() -> dict:
    from psd_tpu_torch.ops import attention, geglu, split3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results: dict = {}
    for shape in ATTN_SHAPES:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        _compare("attention", shape,
                 lambda: attention.attention_fwd(q, k, v),
                 lambda: attention.attention_reference(q, k, v), results)
        del q, k, v
    for (B, S, H, D) in SPLIT3_SHAPES:
        q = randn(B, S, H, D)
        banks = [randn(B, 16, H, D) for _ in range(6)]
        _compare("split3", (B, S, H, D),
                 lambda: split3.split3_fwd(q, *banks, 1.0, 0.1, 0.9),
                 lambda: split3.split3_reference(q, *banks, 1.0, 0.1, 0.9), results)
    for (M, C) in LN_SHAPES:
        x = randn(M, C)
        lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
        lb = randn(C, std=0.1, dtype=torch.float32)
        for n_out in (3, 1):
            ws = tuple(randn(C, C, std=C ** -0.5) for _ in range(n_out))
            _compare("ln_proj", (M, C, n_out),
                     lambda: geglu.ln_proj_fwd(x, lw, lb, ws),
                     lambda: geglu.ln_proj_reference(x, lw, lb, ws), results)
        w0 = randn(8 * C, C, std=C ** -0.5)
        b0 = randn(8 * C, std=0.02, dtype=torch.float32)
        _compare("ln_geglu", (M, C),
                 lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                 lambda: geglu.ln_geglu_reference(x, lw, lb, w0, b0), results)
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
        counts = dict(kernels.launch_counts)
        with disable_kernels(*KERNELS):
            out_p = run()
        torch.cuda.synchronize()
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        ms_k = time_ms(run, n=3, warmup=1)
        with disable_kernels(*KERNELS):
            ms_p = time_ms(run, n=3, warmup=1)
    ok = bool(torch.isfinite(out_k).all()) and rel <= UNET_REL_BAND
    log(f"[unet] SD-scale split3 eps (8,64,64,4), 48 tokens, delta 1.0: "
        f"rel L2 kernels vs plain {rel:.3e} (band {UNET_REL_BAND:g}) "
        f"{'ok' if ok else 'FAIL'}; launches {counts}; "
        f"eps {ms_k:.2f} ms on kernels, {ms_p:.2f} ms plain")
    if not ok or min(counts.values()) == 0:
        raise SystemExit("chip_smoke.py: UNet on the kernels disagrees with the plain "
                         "versions or skipped a kernel")
    del unet, out_k, out_p
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "eps_ms": ms_k, "eps_plain_ms": ms_p}


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
    d512 = kernels.attention_head_dims[512]
    server.close()
    if server._worker.is_alive():
        raise SystemExit("chip_smoke.py: the server worker did not stop")

    checks = {
        "shape (512,512,3)": all(im.shape == (size, size, 3) for im in images),
        "finite": all(np.isfinite(im).all() for im in images),
        "in [0,1]": all(im.min() >= 0.0 and im.max() <= 1.0 for im in images),
        "targets differ": not np.allclose(images[0], images[-1], atol=1e-3),
        "all four kernels launched": min(counts.values()) > 0,
        "attention saw D=512 (VAE)": d512 > 0,
    }
    log(f"[serve] {batch} requests, {size}px, {steps} DDIM steps, steer 1.0, "
        f"max_batch {batch}: wall {wall:.3f} s, {batch / wall:.4f} img/s on {card}")
    log(f"[serve] launches {counts}; attention by head dim {dict(kernels.attention_head_dims)}")
    log(f"[serve] checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke.py: serve checks failed: {checks}")
    return {"counts": counts, "wall_s": wall, "img_per_s": batch / wall}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    card = phase_device()
    phase_build()
    results = phase_kernels()
    phase_unet()
    served = phase_serve(card)

    entries = []
    for name, (replaces, source) in KERNELS.items():
        r = results[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": served["counts"][name], "max_abs_err": r["max_abs_err"],
                 "ms": r["ms"], "plain_ms": r["plain_ms"], "shapes": r["shapes"]}
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
