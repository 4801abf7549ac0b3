#!/usr/bin/env python3
"""Where the time of one SD-scale train step of the PyTorch port goes, on
one NVIDIA GPU.

    python3 scripts/torch_profile_train.py

Builds the training DADD of configs/train_ip.yaml (256², fp32 masters, bf16
compute, gradient checkpointing, EMA from step 0) with seeded random
weights, batch 64, takes one warm-up step, then profiles 2 steps with
torch.profiler (CPU and CUDA activities). Prints the card's name and power
limit, the wall time per step (the profiler slows the host), the device
time per step (the sum of the CUDA kernels' time), the number of kernel
launches per step, the device's idle share of that wall time, and the
kernels and operators with the most device time. Imports nothing of JAX.
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train.py needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.diffusion.dadd import DADD
    from psd_tpu_torch.ops import kernels
    from psd_tpu_torch.train import create_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["training.update_starting_at_step=0"])
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0, for_training=True)
    state, tx = create_train_state(model)
    step = make_train_step(model, tx)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    lat, B = cfg.dataset.image_size // 8, BATCH
    batch = {"latents": torch.randn((B, lat, lat, 4), generator=g, device=dev),
             "labels": torch.randint(0, 4, (B,), generator=g, device=dev).float(),
             "clip_feats": torch.randn((B, 257, 1024), generator=g, device=dev)}
    kernels.library()
    step(state, batch)  # warm-up: cuDNN autotuning, allocator
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
    print(f"[profile] {cfg.dataset.image_size}², batch {B}: wall {wall * 1e3:.2f} ms per step "
          f"(under the profiler), device (kernel) time {device_ms:.2f} ms per step, "
          f"{launches:.0f} kernel launches per step, idle share "
          f"{max(0.0, 1.0 - device_ms / (wall * 1e3)):.4f}", flush=True)
    if device_ms == 0:
        print("[profile] the profiler saw no device time: the breakdown is not measured")
        return 1
    print(events.table(sort_by="self_device_time_total", row_limit=TOP, max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())
