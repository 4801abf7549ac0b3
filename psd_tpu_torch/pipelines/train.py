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
  * Across cards: under torchrun (`torchrun --nproc-per-node N -m
    psd_tpu_torch.pipelines.train ... --dp D --fsdp F`) each process is a
    rank of a (dp, fsdp) mesh (`parallel/mesh.py`; dp −1 takes every rank
    fsdp leaves, dp · fsdp must be the world), on its card (LOCAL_RANK),
    over NCCL on the card and gloo on the CPU (or the caller's group); the
    state goes under DDP (fsdp 1) or FSDP2 (HSDP, fsdp > 1)
    (`train/trainer.py::shard_train_state`). Without torchrun the world is
    one process and the step is the one-card step; a mesh of more ranks
    than the world raises. `batch_size` is the global batch: every rank
    loads all of it with the same seeds, so the augment's draws and the
    encoder's noise are the one-card run's, and encodes and trains on its
    own rows (`parallel.mesh.shard_batch`). The val loss is averaged over
    the ranks; every rank samples the grid (under FSDP2 the parameters are
    gathered for it), rank 0 writes it, the metrics, the log lines and the
    checkpoints (the one-card format, `train/checkpoint.py`).
  * The draws, each for the global batch (a rank takes its rows): each
    step's from the train state's generator (`step_draws`); the encoder's
    from a generator seeded 7 and the step, or 11 for validation batches
    (`encode_noise`, psd_tpu's keys); the val loss's from 1234 and the
    batch (`val_draws`); the grid's initial latent from 99
    (`grid_noise`). Tests patch these to hand JAX's draws.
  * The train step is `compile_train_step(model, tx, mesh)`, as psd_tpu's
    CLI compiles its step: on the card with no mesh, one replay of a
    captured CUDA graph a step, captured at the first step (an eager
    warm-up, which is that step); op by op with a mesh, on the CPU and
    under `core.mode.eager()` (`train/trainer.py`). Validation runs
    eagerly (`core.mode.eager()`): once an epoch, where a captured program
    would keep its pool beside the training state. The val loss runs
    outside training mode, on the serving kernels, as psd_tpu's jitted one
    does.
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
import torch.distributed as dist

from ..convert.npz import load_params_npz
from ..core.config import load_config
from ..core.mode import eager
from ..data.limuc import AugmentConfig, DataLoader, LIMUCDataset
from ..diffusion.dadd import DADD, shard_draws
from ..parallel.mesh import (MeshConfig, batch_rows, create_mesh, launched, rank, rank_device,
                             shard_batch, world_size)
from ..train import (CheckpointManager, build_optimizer, compile_train_step, create_train_state,
                     resolve_resume_path, swapped_in)
from ..train.checkpoint import restore_into, step_dir
from ..train.trainer import full_parameters, shard_train_state
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
                   help="data-parallel degree; -1: every rank --fsdp leaves (torchrun starts "
                        "the ranks, one without it)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="parameter sharding degree (FSDP2 within each dp replica when > 1)")
    p.add_argument("--vae-params", type=str, default=None, help=".npz ported VAE")
    p.add_argument("--clip-params", type=str, default=None, help=".npz ported CLIP")
    add_device_arg(p)
    add_profile_arg(p)
    return p


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
    and each call's), the run's seconds and its checkpoint manager. Under
    torchrun it starts the process group (unless the caller did) and ends
    it on the way out, error or not."""
    args = build_argparser().parse_intermixed_args(argv)
    device = cli_device(args.device)
    mesh_cfg = MeshConfig(dp=args.dp, fsdp=args.fsdp).resolve(world_size())
    if not launched():
        return run(args, device, None)
    started = not dist.is_initialized()
    try:
        mesh = create_mesh(mesh_cfg, device.type)
        return run(args, rank_device(device.type), mesh)
    finally:
        if started:
            dist.destroy_process_group()


def run(args, device: torch.device, mesh) -> dict:
    """The run on this rank (`mesh` None: the one process)."""
    cfg = load_config(args.config, overrides=args.overrides)
    main_rank = rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
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
    rows = batch_rows(mesh, B)  # raises where the ranks do not split B
    loader = DataLoader(ds, batch_size=B, class_balanced=cfg.dataset.sampler == "class_balanced",
                        num_threads=cfg.dataset.num_workers, seed=cfg.training.seed)
    steps_per_epoch = max(len(loader), 1)
    # the LR schedule counts optimizer steps: len(loader) // k an epoch
    accum = max(cfg.training.accumulate_grad_batches or 1, 1)
    tx = build_optimizer(cfg, max(steps_per_epoch // accum, 1))
    state, tx = create_train_state(model, tx=tx)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    ckpt = CheckpointManager(out_dir / "checkpoints")
    resume = resolve_resume_path(cfg.training.resume_checkpoint, out_dir / "checkpoints")
    if resume is not None:
        state = restore_into(state, step_dir(resume))
        say(f"Resumed from {resume} at step {state.step}")
    step_fn = compile_train_step(model, tx, mesh)

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
        once it has any; every rank runs it, each its rows of the loss."""
        tcfg = cfg.training
        ema_active = state.ema.count > 0
        records = {"step": step, "epoch": epoch, "val/ema_swapped": ema_active}
        swap = swapped_in(model.core, state.ema) if ema_active else contextlib.nullcontext()
        with swap, full_parameters(state), torch.no_grad(), eager():
            losses = []
            vloader = DataLoader(val_ds, batch_size=B, shuffle=False, class_balanced=False,
                                 drop_last=False, num_threads=cfg.dataset.num_workers, seed=0)
            for i, vb in enumerate(vloader):
                if i >= tcfg.val_max_batches:
                    break
                (img, cimg, lbl), _ = pad_batch([vb["image"], vb["clip_image"], vb["label"]], B)
                latents, clip_feats = encode_batch(
                    model, img[rows], cimg[rows], encode_noise(model, img, None)[rows])
                draws = val_draws(model, (B,) + tuple(latents.shape[1:]), i)
                loss, _ = model.train_loss(
                    {"latents": latents, "labels": lbl[rows], "clip_feats": clip_feats},
                    draws=shard_draws(draws, rows))
                losses.append(loss.detach().float())
            if losses:
                losses = torch.stack(losses)
                if mesh is not None:  # each rank's mean over its rows → the batch's
                    dist.all_reduce(losses)
                    losses /= dist.get_world_size()
                records["val/loss"] = float(np.mean(losses.tolist()))
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
                if main_rank:
                    progression_grid(imgs, list(levels), path)
                records["val/progression_png"] = str(path)
        logger.log(records)
        if "val/loss" in records:
            say(f"epoch {epoch} val: loss={records['val/loss']:.4f} (ema={ema_active})")

    say(f"Training: {total_steps} steps, {steps_per_epoch} steps/epoch, on {model.device}"
        + ("" if mesh is None else f", rank 0 of {mesh}"))
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
                    mine = shard_batch(mesh, batch)
                    latents, clip_feats = encode_batch(
                        model, mine["image"], mine["clip_image"],
                        encode_noise(model, batch["image"], step)[rows])
                with timer.phase("train_step"):
                    dev_batch = {"latents": latents, "labels": mine["label"],
                                 "clip_feats": clip_feats}
                    shape = (B,) + tuple(latents.shape[1:])
                    state, metrics = step_fn(state, dev_batch,
                                             draws=step_draws(model, state, shape))
                step += 1
                if step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["img_per_sec"] = log_every * B / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    # the AOE statistics every max(10 log intervals, 500) steps
                    if step % max(log_every * 10, 500) < log_every:
                        with full_parameters(state):
                            stats = model.core.ordinal_embedder.embedding_stats()
                            m.update({k: float(v) for k, v in stats.items()})
                    logger.log(m)
                    say(f"step {step}: loss={m['loss']:.4f} ({m['img_per_sec']:.1f} img/s)")
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
        say(f"[profile] trace → {out_dir / 'trace'}\n{timer.report()}")
    say(f"Done at step {step}; checkpoints in {out_dir / 'checkpoints'}")
    return {"state": state, "phases": dict(timer.totals), "laps": dict(timer.laps),
            "seconds": time.perf_counter() - t_start, "checkpoints": ckpt}


if __name__ == "__main__":
    main()
