"""MES progression inference CLI.

    python -m psd_tpu_torch.pipelines.infer --config configs/train_ip.yaml \\
        --structure-image patient.png --mes-steps 13 --steer-scale 1.0

Counterpart of `psd_tpu/pipelines/infer.py`, with its flags, outputs and
refusals: a progression of `--mes-steps` severity levels (linspace
`--mes-start` → `--mes-end`) for one structure image, one initial latent
shared across the levels; single-pass delta steering (`--steer-scale`) in
routing-gates mode, or dual-pass CFG against the negative AOE in baseline
mode (`--guidance-scale`); `--image-scale`, `--zero-image`, `--leace`,
`--eta`; the turbo flags the port serves. It writes `mes_<label>.png` for
each level, `progression_grid.png` and `structure_reference.png` under
`--output-dir`.

  * Device: `--device cuda` (the default; "auto" is the same) runs on the
    card and raises without one; only `--device cpu` runs on the CPU.
  * Weights: drawn from `--seed` (psd_tpu's smoke mode), and with
    `--checkpoint` (a checkpoint root, its latest step, or a step's
    directory; `train/checkpoint.py`) the UNet and conditioning from its
    parameters, or its EMA with `--ema`, and the VAE and CLIP from
    `<checkpoint>/frozen/{vae,clip}.npz` where they exist (psd_tpu's npz,
    `convert/npz.py`). `--ema` without `--checkpoint` raises.
  * The CLIP preprocessing is `CLIPImageProcessor`'s (shortest edge 224,
    bicubic, center crop, 1/255, CLIP mean and std) in PIL and numpy
    (`data/preprocess.py`), so the port needs no `transformers`.
  * One generate call a run, so it runs op by op (`core.mode.eager()`): a
    captured program's first call costs more than it saves once.
  * The initial latents and DDIM's eta noise come from a torch.Generator
    seeded with `--seed`, outside the graph (`initial_draws`).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..conditioning.leace import load_leace
from ..convert.npz import load_params_npz
from ..core.config import Config, load_config
from ..core.mode import eager
from ..data.preprocess import clip_preprocess
from ..diffusion.dadd import DADD
from ..train.checkpoint import load_weights
from ..utils.image_io import progression_grid, save_image, save_sequence
from ..utils.profiling import PhaseTimer, trace_if
from .common import add_device_arg, add_profile_arg, add_turbo_args, build_model, cli_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DADD MES progression inference (GPU)")
    p.add_argument("--config", type=str, default=None, help="training YAML config")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint dir (a root: its latest step; or a step's dir). "
                        "Without it the weights are drawn from --seed (smoke mode)")
    p.add_argument("--structure-image", type=str, required=True)
    p.add_argument("--source-label", type=float, default=0.0)
    p.add_argument("--mes-steps", type=int, default=13)
    p.add_argument("--mes-start", type=float, default=0.0)
    p.add_argument("--mes-end", type=float, default=3.0)
    p.add_argument("--sampling-steps", type=int, default=None)
    p.add_argument("--steer-scale", type=float, default=0.0)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--image-scale", type=float, default=1.0)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--zero-image", action="store_true")
    p.add_argument("--leace", type=str, default=None, help=".npz LEACE projection")
    p.add_argument("--ema", action="store_true",
                   help="sample with the checkpoint's EMA weights (needs --checkpoint)")
    add_device_arg(p)
    p.add_argument("--output-dir", type=str, default="outputs/progression")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    add_turbo_args(p)
    add_profile_arg(p)
    return p


def load_structure_image(path, target_size: int, clip_size: int = 224):
    """→ (CLIP pixels (1, clip_size, clip_size, 3), display image (target,
    target, 3) in [0, 1]). The CLIP preprocessing runs on the display image
    (bilinear resize to the target size first), as psd_tpu's does."""
    display = Image.open(path).convert("RGB").resize((target_size, target_size), Image.BILINEAR)
    display_arr = np.asarray(display, np.float32) / 255.0
    return clip_preprocess(display, clip_size)[None], display_arr


def load_params(model: DADD, checkpoint: Optional[str], use_ema: bool = False) -> DADD:
    """The model's weights: those drawn from the seed, or the checkpoint's
    parameters (its EMA with `use_ema`) and its `frozen/{vae,clip}.npz`
    where present (psd_tpu/pipelines/infer.py:94-139). The CLIP tower is
    built here (`DADD.clip`), outside the timed phases."""
    if use_ema and not checkpoint:
        raise ValueError("--ema needs --checkpoint: the EMA weights come from a checkpoint")
    if checkpoint:
        model.core.load_state_dict(load_weights(checkpoint, ema=use_ema), strict=True)
        frozen = Path(checkpoint) / "frozen"
        trees = {part: load_params_npz(frozen / f"{part}.npz") for part in ("vae", "clip")
                 if (frozen / f"{part}.npz").exists()}
        model.load_flax(vae_tree=trees.get("vae"), clip_tree=trees.get("clip"))
    _ = model.clip  # built and seeded here, outside the timed phases
    return model


def initial_draws(model: DADD, batch: int, image_size: int, steps: int, eta: float,
                  seed: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The initial latent (one, shared by the batch) and, for eta > 0,
    DDIM's per-step noise (steps, batch, h, w, C), from a torch.Generator
    seeded with `seed` on the model's device."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    x0 = model.initial_noise(batch, image_size, g, shared_noise=True)
    if eta <= 0:
        return x0, None
    return x0, torch.randn((steps,) + tuple(x0.shape), generator=g, device=model.device)


def main(argv=None) -> dict:
    """Run the CLI; returns the paths, images, seconds and phase times, and
    the model and conditioning it used."""
    args = build_argparser().parse_args(argv)
    device = cli_device(args.device)
    cfg = load_config(args.config) if args.config else Config()
    image_size = args.image_size or cfg.dataset.image_size
    steps = args.sampling_steps or cfg.diffusion.sampling_steps
    out_dir = Path(args.output_dir)

    model = build_model(cfg, args.dtype, tome_ratio=args.tome_ratio, tome_mode=args.tome_mode,
                        vae_quant=args.vae_quant, device=device, seed=args.seed)
    model = load_params(model, args.checkpoint, args.ema)
    clip_img, display = load_structure_image(args.structure_image, image_size,
                                             clip_size=model.clip_cfg.image_size)
    leace = load_leace(args.leace) if args.leace else None

    n = args.mes_steps
    targets = np.linspace(args.mes_start, args.mes_end, n).astype(np.float32)
    sources = np.full((n,), args.source_label, np.float32)

    use_rg = model.core_cfg.use_routing_gates
    guidance = 1.0 if use_rg else args.guidance_scale  # routing-gates mode forces 1.0
    do_cfg = (not use_rg) and guidance != 1.0
    if args.encoder_stride > 1 and do_cfg:
        raise SystemExit(
            "--encoder-stride > 1 is incompatible with dual-pass CFG "
            f"(baseline mode, --guidance-scale {args.guidance_scale}): the "
            "cached encoder features are conditioning-dependent. Use "
            "--guidance-scale 1 or a routing-gates checkpoint.")

    timer = PhaseTimer(model.device)
    t0 = time.perf_counter()
    with trace_if(out_dir / "trace", enabled=args.profile):
        with timer.phase("clip_encode"):
            feats = model.encode_image_clip(clip_img)
            feats = feats.repeat((n,) + (1,) * (feats.ndim - 1))
        with timer.phase("prepare_cond"):
            kw = dict(image_scale=args.image_scale, zero_image=args.zero_image, leace=leace)
            cond = model.prepare_inference_cond(targets, sources, feats, **kw)
            uncond = (model.prepare_inference_cond(targets, sources, feats, zero_aoe=True, **kw)
                      if do_cfg else None)
        with timer.phase("generate"), eager():
            x0, eta_noise = initial_draws(model, n, image_size, steps, args.eta, args.seed)
            images = model.generate(
                cond, x0=x0, image_size=image_size, sampling_steps=steps,
                steer_scale=args.steer_scale if use_rg else 0.0, guidance_scale=guidance,
                cond_uncond=uncond, eta=args.eta, eta_noise=eta_noise,
                encoder_stride=args.encoder_stride, cache_mode=args.cache_mode,
                sampler=args.sampler).cpu().numpy()
    dt = time.perf_counter() - t0

    paths = save_sequence(images, targets, out_dir)
    grid = progression_grid(images, targets, out_dir / "progression_grid.png", reference=display)
    save_image(display, out_dir / "structure_reference.png")
    print(f"Generated {n}-step progression in {dt:.2f}s ({n / dt:.2f} img/s) → {out_dir}")
    if args.profile:
        print(f"[profile] trace → {out_dir / 'trace'}\n{timer.report()}")
    return {"paths": paths, "grid": grid, "seconds": dt, "images": images,
            "phases": dict(timer.totals), "model": model, "cond": cond, "uncond": uncond}


if __name__ == "__main__":
    main()
