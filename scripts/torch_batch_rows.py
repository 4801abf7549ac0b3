#!/usr/bin/env python3
"""How far a rank's rows drift from the one-process batch, on one NVIDIA GPU.

    python3 scripts/torch_batch_rows.py [--rows 4]

Serving across ranks (`DADD.sample(mesh=)`) runs each rank's rows of a
batch on their own. This builds the serving DADD of configs/train_ip.yaml
at 512² (bf16, seeded random weights), phase 5's first 8 requests of
chip_smoke.py and their batch's noise, and compares rows 0..rows-1 run
alone against the same rows inside the batch of 8, eagerly, with the
kernels on, with the LN kernels off and all plain: one UNet eps, the
latents after 1, 5, 20 and 50 DDIM steps (and the batch of 8 run twice),
and the decoded images beside another noise's. Prints max / mean absolute
and relative L2 differences, the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from psd_tpu_torch.core.config import load_config  # noqa: E402
from psd_tpu_torch.core.mode import KERNELS, disable_kernels, eager  # noqa: E402
from psd_tpu_torch.diffusion.dadd import DADD  # noqa: E402
from psd_tpu_torch.pipelines.serve import SEED_BASE  # noqa: E402

BATCH, STEPS = 8, (1, 5, 20, 50)
MODES = {"kernels": (), "LN kernels off": ("ln_proj", "ln_geglu"), "all plain": KERNELS}


def stats(a: torch.Tensor, b: torch.Tensor) -> str:
    a, b = a.double(), b.double()
    d = (a - b).abs()
    return (f"max {d.max().item():.3e} mean {d.mean().item():.3e} "
            f"rel L2 {((a - b).norm() / b.norm()).item():.3e}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=4, help="a rank's rows of the batch of 8")
    rows = p.parse_args().rows
    card = chip_smoke.phase_device()
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    model = DADD(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    req = chip_smoke._serve_requests(BATCH)[:BATCH]
    cond = model.prepare_inference_cond(np.array([r[1] for r in req], np.float32),
                                        np.array([r[2] for r in req], np.float32),
                                        np.stack([r[0] for r in req]))
    size = cfg.dataset.image_size
    x0 = model.initial_noise(BATCH, size, torch.Generator(device="cuda").manual_seed(SEED_BASE),
                             shared_noise=False)
    other = model.initial_noise(BATCH, size, torch.Generator(device="cuda").manual_seed(5),
                                shared_noise=False)
    for name, off in MODES.items():
        with eager(), torch.inference_mode(), \
                disable_kernels(*off) if off else contextlib.nullcontext():
            t = torch.full((BATCH,), 981, device="cuda")
            whole = model.core.eps(x0, t, cond, 1.0)
            part = model.core.eps(x0[:rows], t[:rows], cond[:rows], 1.0)
            print(f"[rows] {name}: one eps, rows 0-{rows - 1} alone vs in the batch of "
                  f"{BATCH}: {stats(part, whole[:rows])}", flush=True)
            for steps in STEPS:
                lat = model.sample(cond, x0, steps, 1.0)
                alone = model.sample(cond[:rows], x0[:rows], steps, 1.0)
                again = model.sample(cond, x0, steps, 1.0)
                print(f"[rows] {name}: {steps} steps, latents alone vs in the batch: "
                      f"{stats(alone, lat[:rows])}; the batch twice: {stats(again, lat)}",
                      flush=True)
            img, img_alone = model.decode_latents(lat), model.decode_latents(alone)
            img_other = model.decode_latents(model.sample(cond, other, STEPS[-1], 1.0))
            per_image = (img_alone - img[:rows]).abs().mean((1, 2, 3)).tolist()
            print(f"[rows] {name}: {STEPS[-1]}-step images alone vs in the batch: "
                  f"{stats(img_alone, img[:rows])}; per image mean abs "
                  f"{[round(v, 4) for v in per_image]}; another noise vs the batch: "
                  f"{stats(img_other, img)}; on {card}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
