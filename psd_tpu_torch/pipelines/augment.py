"""Balanced synthetic dataset factory.

    python -m psd_tpu_torch.pipelines.augment --config configs/train_ip.yaml \\
        --checkpoint runs/train/checkpoints --data-dir dataset/limuc \\
        --output-dir dataset/limuc_synthetic_balanced --copy-splits

Counterpart of `psd_tpu/pipelines/augment.py`, with its flags and outputs:
for every train image of class X it generates each of the other classes
(`--batch-images` sources × (K − 1) targets a UNet batch), skips outputs
that already exist (resumable), writes `train/<class>/generated_<stem>_src
<src>_to_<tgt>.<bmp|png>` asynchronously (`utils/image_io.py`), and with
`--copy-splits` copies the real train images and the val/test splits
beside them, so the classifier's synthetic-only filter
(`data/classification.py`) picks the generated files out.

  * Device: `--device cuda` (the default; "auto" is the same) runs on the
    card and raises without one; only `--device cpu` runs on the CPU.
  * Weights: from `--seed`, or `--checkpoint` (its EMA with `--ema`) as the
    infer CLI loads them (`pipelines/infer.py::load_params`).
  * One captured program a run: each batch is one replay of
    `DADD.generate` (`diffusion/graphs.py`); the ragged last batch is padded
    to the full batch (`pad_batch`), so it replays the same program.
  * The initial latents, one per image (psd_tpu's `shared_noise=False`),
    come from `initial_draws` on a torch.Generator seeded with `--seed`
    once a run, batch after batch.
  * Baseline mode (no routing gates) with `--guidance-scale` ≠ 1 runs CFG
    against the zero-AOE conditioning; routing-gates mode steers with
    `--steer-scale` and no CFG. `--encoder-stride > 1` with CFG exits.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import load_config
from ..data.limuc import LIMUCDataset
from ..diffusion.dadd import DADD
from ..utils.image_io import AsyncImageWriter
from .common import add_device_arg, add_turbo_args, build_model, cli_device, pad_batch
from .infer import load_params


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DADD synthetic dataset factory (GPU)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--batch-images", type=int, default=4)
    p.add_argument("--sampling-steps", type=int, default=None)
    p.add_argument("--steer-scale", type=float, default=1.0)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--copy-splits", action="store_true",
                   help="copy originals + val/test into output dataset")
    p.add_argument("--format", type=str, default="bmp", choices=["bmp", "png"],
                   help="bmp: the native BMP writer; png compresses")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    add_device_arg(p)
    add_turbo_args(p)
    return p


def collect_pending_jobs(ds: LIMUCDataset, out_dir: Path, num_classes: int,
                         max_images: Optional[int] = None,
                         ext: str = "bmp") -> List[Tuple[int, float, float, Path]]:
    """(sample index, source label, target label, output path) for every
    train image × every other class whose output (.bmp or .png) is not
    written yet. The source class is in the name, so identically named
    files of two classes do not overwrite each other."""
    jobs = []
    n = len(ds.samples) if max_images is None else min(max_images, len(ds.samples))
    idx_to_class = {v: k for k, v in ds.class_to_idx.items()}
    for idx in range(n):
        path, src = ds.samples[idx]
        for tgt in range(num_classes):
            if tgt == src:
                continue
            cls_dir = out_dir / "train" / idx_to_class[tgt]
            stem = f"generated_{path.stem}_src{src}_to_{tgt}"
            if any((cls_dir / f"{stem}.{e}").exists() for e in ("bmp", "png")):
                continue
            jobs.append((idx, float(src), float(tgt), cls_dir / f"{stem}.{ext}"))
    return jobs


def copy_splits(data_dir: Path, out_dir: Path) -> None:
    """Copy the real train images and the val/test splits, file by file,
    keeping any already there."""
    for split in ("train", "val", "test"):
        src = data_dir / split
        if not src.exists():
            continue
        for cls_dir in src.iterdir():
            if not cls_dir.is_dir():
                continue
            dst = out_dir / split / cls_dir.name
            dst.mkdir(parents=True, exist_ok=True)
            for f in cls_dir.iterdir():
                if f.is_file() and not (dst / f.name).exists():
                    shutil.copy2(f, dst / f.name)


def initial_draws(model: DADD, generator: torch.Generator, batch: int,
                  image_size: int) -> torch.Tensor:
    """One batch's initial latents (batch, h, w, C), one per image, from
    `generator` (seeded once a run, drawn from batch after batch)."""
    return model.initial_noise(batch, image_size, generator, shared_noise=False)


def runs_cfg(use_routing_gates: bool, guidance_scale: float) -> bool:
    """Whether a scale runs CFG: baseline mode at a guidance other than 1."""
    return not use_routing_gates and guidance_scale != 1.0


def conditioning(model: DADD, ds: LIMUCDataset, chunk, full: int, guidance_scale: float):
    """A chunk of (sample index, source, target, ...) jobs, padded to `full`
    → (cond, uncond or None, the guidance, the real count). Baseline mode
    with guidance ≠ 1 runs CFG against the zero-AOE conditioning."""
    srcs = np.asarray([j[1] for j in chunk], np.float32)
    tgts = np.asarray([j[2] for j in chunk], np.float32)
    clip_imgs = np.stack([ds.load(j[0])["clip_image"] for j in chunk])
    (srcs, tgts, clip_imgs), n_real = pad_batch([srcs, tgts, clip_imgs], full)
    feats = model.encode_image_clip(clip_imgs)
    cond = model.prepare_inference_cond(tgts, srcs, feats)
    if not runs_cfg(model.core_cfg.use_routing_gates, guidance_scale):
        return cond, None, 1.0, n_real
    uncond = model.prepare_inference_cond(tgts, srcs, feats, zero_aoe=True)
    return cond, uncond, guidance_scale, n_real


def main(argv=None) -> dict:
    """Run the factory; returns the count generated, the seconds, each
    batch's seconds and the model."""
    args = build_argparser().parse_args(argv)
    device = cli_device(args.device)
    cfg = load_config(args.config)
    image_size = args.image_size or cfg.dataset.image_size
    steps = args.sampling_steps or cfg.diffusion.sampling_steps
    num_classes = cfg.dataset.num_classes
    out_dir, data_dir = Path(args.output_dir), Path(args.data_dir)

    if args.encoder_stride > 1 and args.guidance_scale != 1.0:
        raise SystemExit("--encoder-stride > 1 is incompatible with "
                         "dual-pass CFG (--guidance-scale != 1)")
    model = build_model(cfg, args.dtype, tome_ratio=args.tome_ratio, tome_mode=args.tome_mode,
                        vae_quant=args.vae_quant, device=device, seed=args.seed)
    model = load_params(model, args.checkpoint, args.ema)
    ds = LIMUCDataset(data_dir / "train", image_size=image_size, return_clip=True,
                      clip_size=model.clip_cfg.image_size, seed=args.seed)
    if args.copy_splits:
        copy_splits(data_dir, out_dir)

    jobs = collect_pending_jobs(ds, out_dir, num_classes, args.max_images, ext=args.format)
    print(f"{len(jobs)} pending generation jobs")
    if not jobs:
        return {"generated": 0, "model": model}

    use_rg = model.core_cfg.use_routing_gates
    writer = AsyncImageWriter()
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    full = args.batch_images * (num_classes - 1)
    t0 = time.perf_counter()
    done, laps = 0, []
    try:
        for b in range(0, len(jobs), full):
            t = time.perf_counter()
            chunk = jobs[b:b + full]
            cond, uncond, guidance, n_real = conditioning(model, ds, chunk, full,
                                                          args.guidance_scale)
            x0 = initial_draws(model, generator, full, image_size)
            imgs = model.generate(
                cond, x0=x0, image_size=image_size, sampling_steps=steps,
                steer_scale=args.steer_scale if use_rg else 0.0, guidance_scale=guidance,
                cond_uncond=uncond, encoder_stride=args.encoder_stride,
                cache_mode=args.cache_mode, sampler=args.sampler).cpu().numpy()[:n_real]
            for img, job in zip(imgs, chunk):
                writer.submit(img, job[3])
            done += len(imgs)
            laps.append(time.perf_counter() - t)
            if b // full % 10 == 0:
                dt = time.perf_counter() - t0
                print(f"  {done}/{len(jobs)} ({done / max(dt, 1e-9):.2f} img/s)")
    finally:
        writer.close()
    dt = time.perf_counter() - t0
    print(f"Generated {done} images in {dt:.1f}s ({done / dt:.2f} img/s) → {out_dir}")
    return {"generated": done, "seconds": dt, "batch_seconds": laps, "model": model}


if __name__ == "__main__":
    main()
