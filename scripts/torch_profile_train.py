#!/usr/bin/env python3
"""Where the time of one SD-scale train step of the PyTorch port goes, on
one NVIDIA GPU.

    python3 scripts/torch_profile_train.py [--compiled]

Builds the training DADD of configs/train_ip.yaml (256², fp32 masters, bf16
compute, gradient checkpointing, EMA from step 0) with seeded random
weights, batch 64, takes one warm-up step, then profiles 2 steps with
torch.profiler (CPU and CUDA activities). Prints the card's name and power
limit, the wall time per step (the profiler slows the host), the device
time per step (the sum of the CUDA kernels' time), the number of kernel
launches per step, the device's idle share of that wall time, and the
kernels and operators with the most device time. With `--compiled` it then
does the same for `compile_train_step` on the same state: its first call
warms up and captures the step's program, and the 2 profiled steps are
replays; the two steps' lines are printed one after the other. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


BATCH, STEPS, TOP = 64, 2, 30


def profile_steps(step, state, batch, label: str) -> int:
    """One warm-up call of `step`, then `STEPS` calls under torch.profiler;
    prints the reading and the top of the table. 1 if no device time was
    seen."""
    from torch.profiler import ProfilerActivity, profile

    step(state, batch)  # warm-up: cuDNN autotuning, allocator (a capture when compiled)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
    events = prof.key_averages()
    # device work only: GPU user annotations (autograd.Function and optimizer
    # ranges) span kernels that are counted on their own
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / STEPS
    launches = sum(e.count for e in device) / STEPS
    print(f"[profile] {label}, batch {BATCH}: wall {wall * 1e3:.2f} ms per step "
          f"(under the profiler), device (kernel) time {device_ms:.2f} ms per step, "
          f"{launches:.0f} kernels per step, idle share "
          f"{max(0.0, 1.0 - device_ms / (wall * 1e3)):.4f}", flush=True)
    if device_ms == 0:
        print("[profile] the profiler saw no device time: the breakdown is not measured")
        return 1
    print(events.table(sort_by="self_device_time_total", row_limit=TOP, max_name_column_width=70))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compiled", action="store_true",
                    help="also profile compile_train_step's replayed step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train.py needs a CUDA GPU")
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.train import compile_train_step, create_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["training.update_starting_at_step=0"])
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0, for_training=True)
    state, tx = create_train_state(model)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    lat = cfg.dataset.image_size // 8
    batch = {"latents": torch.randn((BATCH, lat, lat, 4), generator=g, device=dev),
             "labels": torch.randint(0, 4, (BATCH,), generator=g, device=dev).float(),
             "clip_feats": torch.randn((BATCH, 257, 1024), generator=g, device=dev)}
    kernels.library()
    size = cfg.dataset.image_size
    rc = profile_steps(make_train_step(model, tx), state, batch, f"eager step, {size}²")
    if args.compiled:
        rc |= profile_steps(compile_train_step(model, tx), state, batch,
                            f"compiled step (CUDA-graph replay), {size}²")
    return rc


if __name__ == "__main__":
    sys.exit(main())
