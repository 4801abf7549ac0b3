"""Training CLI: DADD on a class-per-directory image tree.

    python -m psd_tpu_torch.pipelines.train --config configs/train_ip.yaml \\
        dataset.dataset_path=<tree> --output-dir runs/train

Counterpart of `psd_tpu/pipelines/train.py`, with its flags and flow: the
YAML config with dotted overrides → the model with fp32 masters → the
LIMUC loader over `<dataset_path>/train` → each batch encoded by the frozen
VAE and CLIP (`DADD.encode_latents`, `encode_image_clip`) → the train step
(loss, gradients, clip + AdamW, EMA) → JSONL metrics every
`log_every_n_steps` (loss, grad norm, img/s; the routing gates once; the
AOE embedding statistics every max(10 × log_every, 500) steps) → a
checkpoint at each epoch's end (`train/checkpoint.py`) → validation every
`check_val_every_n_epochs` on `<dataset_path>/val` with the EMA's weights
swapped in: the val loss over `val_max_batches` batches and a progression
grid of `val_progression_levels` levels → resume from a path or "last".

  * Device: `--device cuda` (the default; "auto" is the same) runs on the
    card and raises without one; only `--device cpu` runs on the CPU.
  * One card: `--dp` takes −1 or 1 and `--fsdp` 1; other values raise
    (data parallelism is ROADMAP.md Queue 1 item 5's DDP step).
  * The draws: each step's from the train state's generator
    (`step_draws`); the encoder's from a generator seeded 7 and the step,
    or 11 for validation batches (`encode_noise`, psd_tpu's keys); the val
    loss's from 1234 and the batch (`val_draws`); the grid's initial
    latent from 99 (`grid_noise`). Tests patch these to hand JAX's draws.
  * The train step runs eagerly. Validation runs eagerly too
    (`core.mode.eager()`): once an epoch, where a captured program would
    keep its pool beside the training state. The val loss runs outside
    training mode, on the serving kernels, as psd_tpu's jitted one does.
  * The phases (data, encode, train_step, checkpoint, validation) are
    timed. Only `--profile` ends each with a synchronize of the card (as
    psd_tpu syncs only then), so a plain run keeps the host enqueueing
    ahead of the device; it also writes a torch.profiler trace under
    `<output-dir>/trace` and prints the report.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..convert.npz import load_params_npz
from ..core.config import load_config
from ..core.mode import eager
from ..data.limuc import AugmentConfig, DataLoader, LIMUCDataset
from ..diffusion.dadd import DADD
from ..train import (CheckpointManager, build_optimizer, create_train_state, make_train_step,
                     resolve_resume_path, swapped_in)
from ..train.checkpoint import restore_into, step_dir
from ..utils.image_io import progression_grid
from ..utils.logging import MetricLogger
from ..utils.profiling import PhaseTimer, trace_if
from .common import add_device_arg, add_profile_arg, build_model, cli_device, pad_batch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DADD training (GPU)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    p.add_argument("--output-dir", type=str, default="runs/train")
    p.add_argument("--max-steps", type=int, default=None, help="cap total steps (smoke runs)")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel degree: -1 (all cards) or 1; one card for now")
    p.add_argument("--fsdp", type=int, default=1, help="parameter sharding degree: 1 for now")
    p.add_argument("--vae-params", type=str, default=None, help=".npz ported VAE")
    p.add_argument("--clip-params", type=str, default=None, help=".npz ported CLIP")
    add_device_arg(p)
    add_profile_arg(p)
    return p


def check_parallel(dp: int, fsdp: int) -> None:
    """One card: dp −1 (all of them) or 1, fsdp 1."""
    if dp not in (-1, 1) or fsdp != 1:
        raise NotImplementedError(
            f"--dp {dp} --fsdp {fsdp}: the port trains on one card; data parallelism (DDP, "
            "then FSDP) is the next step of ROADMAP.md Queue 1 item 5. Use --dp 1 --fsdp 1")


def _generator(model: DADD, seed: int) -> torch.Generator:
    return torch.Generator(device=model.device).manual_seed(seed)


def encode_noise(model: DADD, images, step: Optional[int]) -> torch.Tensor:
    """N(0, 1) for the VAE's draw of the latents of `images` (B, H, W, 3):
    seeded 7 and the step for a training batch (psd_tpu: fold_in(PRNGKey(7),
    step)), 11 for a validation batch (PRNGKey(11))."""
    B, H, W, _ = images.shape
    f = model.spatial_factor
    shape = (B, H // f, W // f, model.vae_cfg.latent_channels)
    seed = 11 if step is None else (7 << 32) + step
    return torch.randn(shape, generator=_generator(model, seed), device=model.device)


def step_draws(model: DADD, state, shape) -> Dict[str, torch.Tensor]:
    """One train step's draws, from the train state's generator."""
    return model.sample_draws(shape, state.generator)


def val_draws(model: DADD, shape, i: int) -> Dict[str, torch.Tensor]:
    """The val loss's draws for batch i, the same every epoch (psd_tpu:
    fold_in(PRNGKey(1234), i))."""
    return model.sample_draws(shape, _generator(model, (1234 << 32) + i))


def grid_noise(model: DADD, batch: int, image_size: int) -> torch.Tensor:
    """The progression grid's initial latent, shared by its levels, the
    same every epoch (psd_tpu: PRNGKey(99))."""
    return model.initial_noise(batch, image_size, _generator(model, 99), shared_noise=True)


def encode_batch(model: DADD, images, clip_images, noise):
    """Images in [−1, 1] and CLIP pixels → (scaled latents, CLIP features),
    both fp32 and outside autograd."""
    latents = model.encode_latents(images, noise=noise)
    # a copy made outside inference mode, which autograd may save
    return latents, model.encode_image_clip(clip_images).clone()


def main(argv=None) -> dict:
    """Run the CLI; returns the final train state, the phase times (totals
    and each call's), the run's seconds and its checkpoint manager."""
    args = build_argparser().parse_intermixed_args(argv)
    device = cli_device(args.device)
    check_parallel(args.dp, args.fsdp)
    cfg = load_config(args.config, overrides=args.overrides)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = build_model(cfg, device=device, seed=cfg.training.seed, for_training=True)
    if args.vae_params or args.clip_params:
        model.load_flax(vae_tree=args.vae_params and load_params_npz(args.vae_params),
                        clip_tree=args.clip_params and load_params_npz(args.clip_params))

    aug = AugmentConfig(**{k: v for k, v in cfg.dataset.augmentation.items()
                           if k in AugmentConfig.__dataclass_fields__})
    ds = LIMUCDataset(Path(cfg.dataset.dataset_path) / "train", image_size=cfg.dataset.image_size,
                      augment=aug, return_clip=True, clip_size=model.clip_cfg.image_size,
                      seed=cfg.training.seed)
    B = cfg.dataset.batch_size
    loader = DataLoader(ds, batch_size=B, class_balanced=cfg.dataset.sampler == "class_balanced",
                        num_threads=cfg.dataset.num_workers, seed=cfg.training.seed)
    steps_per_epoch = max(len(loader), 1)
    # the LR schedule counts optimizer steps: len(loader) // k an epoch
    accum = max(cfg.training.accumulate_grad_batches or 1, 1)
    tx = build_optimizer(cfg, max(steps_per_epoch // accum, 1))
    state, tx = create_train_state(model, tx=tx)
    ckpt = CheckpointManager(out_dir / "checkpoints")
    resume = resolve_resume_path(cfg.training.resume_checkpoint, out_dir / "checkpoints")
    if resume is not None:
        state = restore_into(state, step_dir(resume))
        print(f"Resumed from {resume} at step {state.step}")
    step_fn = make_train_step(model, tx)

    total_steps = args.max_steps or steps_per_epoch * cfg.training.max_epochs
    log_every = cfg.training.log_every_n_steps
    step = state.step
    val_ds = None
    val_dir = Path(cfg.dataset.dataset_path) / "val"
    if val_dir.exists() and cfg.training.check_val_every_n_epochs > 0:
        val_ds = LIMUCDataset(val_dir, image_size=cfg.dataset.image_size, return_clip=True,
                              clip_size=model.clip_cfg.image_size, seed=cfg.training.seed)
    sample_dir = out_dir / "val_samples"

    def run_validation(epoch: int) -> None:
        """The val loss and a fixed progression grid, on the EMA's weights
        once it has any."""
        tcfg = cfg.training
        ema_active = state.ema.count > 0
        records = {"step": step, "epoch": epoch, "val/ema_swapped": ema_active}
        swap = swapped_in(model.core, state.ema) if ema_active else contextlib.nullcontext()
        with swap, torch.no_grad(), eager():
            losses = []
            vloader = DataLoader(val_ds, batch_size=B, shuffle=False, class_balanced=False,
                                 drop_last=False, num_threads=cfg.dataset.num_workers, seed=0)
            for i, vb in enumerate(vloader):
                if i >= tcfg.val_max_batches:
                    break
                (img, cimg, lbl), _ = pad_batch([vb["image"], vb["clip_image"], vb["label"]], B)
                latents, clip_feats = encode_batch(
                    model, img, cimg, encode_noise(model, img, None))
                loss, _ = model.train_loss(
                    {"latents": latents, "labels": lbl, "clip_feats": clip_feats},
                    draws=val_draws(model, tuple(latents.shape), i))
                losses.append(float(loss))
            if losses:
                records["val/loss"] = float(np.mean(losses))
            if tcfg.val_progression_levels > 0:
                item = val_ds.load(0)
                K = tcfg.val_progression_levels
                levels = np.linspace(0, cfg.dataset.num_classes - 1, K)
                feats = model.encode_image_clip(np.stack([item["clip_image"]] * K))
                cond = model.prepare_inference_cond(levels.astype(np.float32),
                                                    np.full((K,), item["label"], np.float32),
                                                    feats)
                lat = model.sample(cond, grid_noise(model, K, cfg.dataset.image_size),
                                   sampling_steps=tcfg.val_sampling_steps,
                                   steer_scale=1.0 if cfg.model.use_routing_gates else 0.0)
                imgs = model.decode_latents(lat).cpu().numpy()
                path = sample_dir / f"epoch{epoch:04d}.png"
                progression_grid(imgs, list(levels), path)
                records["val/progression_png"] = str(path)
        logger.log(records)
        if "val/loss" in records:
            print(f"epoch {epoch} val: loss={records['val/loss']:.4f} (ema={ema_active})")

    print(f"Training: {total_steps} steps, {steps_per_epoch} steps/epoch, on {model.device}")
    timer = PhaseTimer(model.device, sync=args.profile)
    t_start = t0 = time.perf_counter()
    done = step >= total_steps
    with MetricLogger(out_dir / "metrics.jsonl", wandb_cfg=cfg.wandb) as logger, \
            trace_if(out_dir / "trace", enabled=args.profile):
        if cfg.model.use_routing_gates:
            # static config values (the reference logs them each epoch)
            logger.log({"step": 0,
                        "gates/anatomy_anat": cfg.model.gate_init_anatomy[0],
                        "gates/anatomy_dis": cfg.model.gate_init_anatomy[1],
                        "gates/disease_anat": cfg.model.gate_init_disease[0],
                        "gates/disease_dis": cfg.model.gate_init_disease[1]})
        while not done:
            batches = iter(loader)
            while True:
                with timer.phase("data"):
                    batch = next(batches, None)
                if batch is None:
                    break
                with timer.phase("encode"):
                    latents, clip_feats = encode_batch(
                        model, batch["image"], batch["clip_image"],
                        encode_noise(model, batch["image"], step))
                with timer.phase("train_step"):
                    dev_batch = {"latents": latents, "labels": batch["label"],
                                 "clip_feats": clip_feats}
                    state, metrics = step_fn(state, dev_batch,
                                             draws=step_draws(model, state, tuple(latents.shape)))
                step += 1
                if step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["img_per_sec"] = log_every * B / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    # the AOE statistics every max(10 log intervals, 500) steps
                    if step % max(log_every * 10, 500) < log_every:
                        stats = model.core.ordinal_embedder.embedding_stats()
                        m.update({k: float(v) for k, v in stats.items()})
                    logger.log(m)
                    print(f"step {step}: loss={m['loss']:.4f} ({m['img_per_sec']:.1f} img/s)")
                if step % steps_per_epoch == 0:
                    with timer.phase("checkpoint"):
                        ckpt.save(step, state)
                    epoch = step // steps_per_epoch
                    if val_ds is not None and epoch % cfg.training.check_val_every_n_epochs == 0:
                        with timer.phase("validation"):
                            run_validation(epoch)
                if step >= total_steps:
                    done = True
                    break
    if ckpt.latest_step() != step:
        with timer.phase("checkpoint"):
            ckpt.save(step, state)
    ckpt.wait()
    if args.profile:
        print(f"[profile] trace → {out_dir / 'trace'}\n{timer.report()}")
    print(f"Done at step {step}; checkpoints in {out_dir / 'checkpoints'}")
    return {"state": state, "phases": dict(timer.totals), "laps": dict(timer.laps),
            "seconds": time.perf_counter() - t_start, "checkpoints": ckpt}


if __name__ == "__main__":
    main()
