"""Evaluation sweep CLI: FID, CMMD and improved precision / recall per
checkpoint and scale.

    python -m psd_tpu_torch.pipelines.evaluate --config configs/train_ip.yaml \\
        --checkpoints runs/train/checkpoints --data-dir dataset/limuc \\
        --inception-params inception.npz --vgg-params vgg16.npz

Counterpart of `psd_tpu/pipelines/evaluate.py`, with its flags and outputs:
for each checkpoint × each scale (steer in routing-gates mode, CFG guidance
in baseline mode) it generates the (K − 1) other classes of every source
image of `--split` (`--max-per-class` a class), `--batch-images` sources a
UNet batch, then scores FID (InceptionV3 pool3), CMMD (CLIP ViT-L/14
embeddings) and improved precision / recall (VGG16 fc7) per class and a
class-balanced overall over `--num-eval-seeds` subsamples. Writes
`<run>/metrics.json` per run and `comparison.json`, and prints the
comparison table and each run's img/s.

  * Device: `--device cuda` (the default; "auto" is the same) runs on the
    card and raises without one; only `--device cpu` runs on the CPU.
  * The metric backbones run in bf16, as psd_tpu's `FeatureBank`
    (Inception's input cast to bf16 before its 299² resize; VGG's resized
    to 224² in float32, then cast). Their weights come from
    `--inception-params` / `--vgg-params` (psd_tpu's npz, through the
    bridge); without them the run refuses, unless
    `--allow-random-backbones` (smoke runs: the values mean nothing).
  * CLIP sees the images as `CLIPImageProcessor` does when handed floats in
    [0, 1] (`data/preprocess.py::clip_preprocess_float`).
  * Generation replays one captured program a checkpoint (`DADD.generate`,
    the ragged last batch padded): the scale is the steer (or the guidance)
    of every batch, a program input, so every scale replays the program the
    first captured. In baseline mode a scale of 1 runs without CFG, which is
    another program. A checkpoint's programs are dropped after its last
    scale and before a scale that needs another program (`drops_after`), so
    the sweep holds one program's pool beside the backbones at a time
    (`DADD.drop_programs`). Each checkpoint after the first
    gets a model built anew from `--seed`, as psd_tpu draws every
    checkpoint's VAE and CLIP anew before loading it, so nothing of the
    previous checkpoint (its frozen weights, the int8 decoder weights
    computed from them) survives.
  * Each scale's initial latents come from `augment.initial_draws` on a
    torch.Generator seeded with `--seed` at the scale's start.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert.from_jax import load_variables_
from ..convert.npz import load_params_npz
from ..core.config import load_config
from ..data.limuc import LIMUCDataset
from ..data.preprocess import clip_preprocess_float
from ..diffusion.dadd import DADD
from ..metrics.cmmd import compute_cmmd, l2_normalize
from ..metrics.comparison import comparison_table
from ..metrics.fid import fid_from_features
from ..metrics.prdc import improved_precision_recall
from ..models.inception import InceptionV3Features, inception_preprocess
from ..models.init import flax_init_
from ..models.resize import resize_bilinear
from ..models.vgg import VGG16Features, imagenet_normalize
from ..utils.image_io import AsyncImageWriter
from ..utils.profiling import PhaseTimer, trace_if
from . import augment
from .common import (add_device_arg, add_profile_arg, add_turbo_args, build_model, cli_device)
from .infer import load_params


@dataclass
class EvalResult:
    """One (checkpoint, scale) run's metrics."""

    checkpoint: str
    scale: float
    per_class: Dict[str, Dict[str, float]] = field(default_factory=dict)
    overall: Dict[str, float] = field(default_factory=dict)
    throughput_img_s: float = 0.0
    num_generated: int = 0

    def to_json(self) -> Dict:
        return asdict(self)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DADD evaluation sweep (GPU)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoints", type=str, nargs="+", default=[None])
    p.add_argument("--scales", type=float, nargs="+", default=[1.0, 2.0, 3.0])
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--batch-images", type=int, default=4)
    p.add_argument("--sampling-steps", type=int, default=None)
    p.add_argument("--max-per-class", type=int, default=50)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-eval-seeds", type=int, default=5)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--save-images", action="store_true")
    p.add_argument("--output-dir", type=str, default="runs/eval")
    p.add_argument("--inception-params", type=str, default=None)
    p.add_argument("--vgg-params", type=str, default=None)
    p.add_argument("--allow-random-backbones", action="store_true",
                   help="smoke runs only: proceed with random-init "
                        "Inception/VGG (FID/IPR values are meaningless)")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    add_device_arg(p)
    add_turbo_args(p)
    add_profile_arg(p)
    return p


def collect_jobs(ds: LIMUCDataset, num_classes: int, max_per_class: int):
    """(sample index, source label, target label) for the first
    `max_per_class` images of each class × the (K − 1) other classes."""
    jobs = []
    per_class_count = {c: 0 for c in range(num_classes)}
    for idx, (_, lbl) in enumerate(ds.samples):
        if per_class_count[lbl] >= max_per_class:
            continue
        per_class_count[lbl] += 1
        for tgt in range(num_classes):
            if tgt != lbl:
                jobs.append((idx, float(lbl), float(tgt)))
    return jobs


# the metric backbones' compute dtype and batch (psd_tpu's FeatureBank's)
BACKBONE_DTYPE, FEATURE_BATCH = torch.bfloat16, 32


class FeatureBank:
    """The three metric backbones' features of images in [0, 1], as
    float32 tensors on the model's device, FEATURE_BATCH images a call:
    Inception pool3 and VGG16 fc7 in bf16, and the model's CLIP tower's
    L2-normalized image embeddings. `model` may be replaced between
    checkpoints; the backbones are built once, at their first use, from
    psd_tpu's variables trees or, with `allow_random_backbones`, seeded at
    random; without either they refuse."""

    def __init__(self, model: DADD, inception_params=None, vgg_params=None,
                 allow_random_backbones: bool = False):
        self.model = model
        self._trees = {"inception": inception_params, "vgg": vgg_params}
        self._allow_random = allow_random_backbones
        self._nets: Dict[str, torch.nn.Module] = {}

    def _net(self, name: str) -> torch.nn.Module:
        if name in self._nets:
            return self._nets[name]
        if any(t is None for t in self._trees.values()) and not self._allow_random:
            raise RuntimeError(
                "Metric backbones have no pretrained weights (--inception-params / "
                "--vgg-params). Port them with scripts/torch_port_weights.py, or pass "
                "--allow-random-backbones for smoke runs only (random-init values).")
        dev = self.model.device
        with dev:
            net = (InceptionV3Features if name == "inception" else VGG16Features)(BACKBONE_DTYPE)
        net.eval().requires_grad_(False)
        tree = self._trees[name]
        if tree is None:
            flax_init_(net, torch.Generator(device=dev).manual_seed(0 if name == "inception" else 1))
            print(f"WARNING: random-init {name} (no --{name}-params); its metric is smoke-only")
        else:
            load_variables_(net, tree)
        self._nets[name] = net
        return net

    @torch.inference_mode()
    def _batched(self, fn, images) -> torch.Tensor:
        dev = self.model.device
        return torch.cat([fn(torch.as_tensor(np.asarray(images[i:i + FEATURE_BATCH]),
                                             dtype=torch.float32, device=dev))
                          for i in range(0, len(images), FEATURE_BATCH)])

    def inception(self, images: np.ndarray) -> torch.Tensor:
        net = self._net("inception")
        return self._batched(lambda x: net(inception_preprocess(x.to(BACKBONE_DTYPE))).float(),
                             images)

    def vgg(self, images: np.ndarray) -> torch.Tensor:
        net = self._net("vgg")

        def fn(x):
            x = resize_bilinear(x, 224, 224)
            return net(imagenet_normalize(x.to(BACKBONE_DTYPE))).float()

        return self._batched(fn, images)

    def clip(self, images: np.ndarray) -> torch.Tensor:
        size = self.model.clip_cfg.image_size
        pre = np.stack([clip_preprocess_float(np.asarray(im, np.float32), size) for im in images])
        tower = self.model.clip
        return self._batched(lambda x: l2_normalize(tower.image_embeds(x).float()), pre)


def evaluate_one_run(real_by_class: Dict[int, np.ndarray], fake_by_class: Dict[int, np.ndarray],
                     bank: FeatureBank, num_eval_seeds: int = 5,
                     seed: int = 0) -> Tuple[Dict, Dict]:
    """Per-class FID / CMMD / precision / recall, and the class-balanced
    overall: each class subsampled to the smallest class's count, over
    `num_eval_seeds` draws of one numpy generator seeded `seed`; mean and
    std of each metric."""
    per_class: Dict[str, Dict[str, float]] = {}
    feats = {}
    for cls in sorted(real_by_class):
        real, fake = real_by_class[cls], fake_by_class.get(cls)
        if fake is None or len(fake) < 2 or len(real) < 2:
            continue
        f = dict(fr=bank.inception(real), ff=bank.inception(fake), cr=bank.clip(real),
                 cf=bank.clip(fake), vr=bank.vgg(real), vf=bank.vgg(fake))
        feats[cls] = f
        p, r = improved_precision_recall(f["vr"], f["vf"])
        per_class[str(cls)] = {
            "fid": fid_from_features(f["fr"].cpu().numpy(), f["ff"].cpu().numpy()),
            "cmmd": compute_cmmd(f["cr"], f["cf"]),
            "precision": p,
            "recall": r,
            "n_real": len(real),
            "n_fake": len(fake),
        }

    overall: Dict[str, float] = {}
    if feats:
        n_min_r = min(len(v["fr"]) for v in feats.values())
        n_min_f = min(len(v["ff"]) for v in feats.values())
        vals = {"fid": [], "cmmd": [], "precision": [], "recall": []}
        rng = np.random.default_rng(seed)
        for _ in range(num_eval_seeds):
            picked = {k: [] for k in ("fr", "ff", "cr", "cf", "vr", "vf")}
            for v in feats.values():
                ir = torch.as_tensor(rng.choice(len(v["fr"]), n_min_r, replace=False))
                iff = torch.as_tensor(rng.choice(len(v["ff"]), n_min_f, replace=False))
                for k in picked:  # "?r": the real images' features, "?f": the fakes'
                    picked[k].append(v[k][ir if k.endswith("r") else iff])
            cat = {k: torch.cat(v) for k, v in picked.items()}
            vals["fid"].append(fid_from_features(cat["fr"].cpu().numpy(), cat["ff"].cpu().numpy()))
            vals["cmmd"].append(compute_cmmd(cat["cr"], cat["cf"]))
            p, r = improved_precision_recall(cat["vr"], cat["vf"])
            vals["precision"].append(p)
            vals["recall"].append(r)
        for k, v in vals.items():
            overall[k] = float(np.mean(v))
            overall[k + "_std"] = float(np.std(v))
    return per_class, overall


def generate_all(model: DADD, ds: LIMUCDataset, jobs, scale: float, image_size: int, steps: int,
                 batch_images: int, num_classes: int, seed: int,
                 writer: Optional[AsyncImageWriter] = None, out_dir: Optional[Path] = None,
                 encoder_stride: int = 1, cache_mode: str = "encoder",
                 sampler: str = "ddim") -> Tuple[Dict[int, np.ndarray], float]:
    """Every job's image at `scale` (steer with routing gates, CFG guidance
    without), `batch_images` × (K − 1) a batch → (the images by target
    class, img/s)."""
    use_rg = model.core_cfg.use_routing_gates
    fake_by_class: Dict[int, List[np.ndarray]] = {c: [] for c in range(num_classes)}
    full = batch_images * (num_classes - 1)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    t0 = time.perf_counter()
    total = 0
    for b in range(0, len(jobs), full):
        chunk = jobs[b:b + full]
        cond, uncond, guidance, n_real = augment.conditioning(model, ds, chunk, full, scale)
        x0 = augment.initial_draws(model, generator, full, image_size)
        imgs = model.generate(
            cond, x0=x0, image_size=image_size, sampling_steps=steps,
            steer_scale=scale if use_rg else 0.0, guidance_scale=guidance, cond_uncond=uncond,
            encoder_stride=encoder_stride, cache_mode=cache_mode,
            sampler=sampler).cpu().numpy()[:n_real]
        total += len(imgs)
        for img, (idx, _, tgt) in zip(imgs, chunk):
            fake_by_class[int(tgt)].append(img)
            if writer is not None and out_dir is not None:
                writer.submit(img, out_dir / f"class_{int(tgt)}" / f"gen_{idx}_{int(tgt)}.png")
    dt = time.perf_counter() - t0
    return ({c: np.stack(v) if v else np.zeros((0,)) for c, v in fake_by_class.items()},
            total / dt if dt > 0 else 0.0)


def drops_after(scales, use_routing_gates: bool) -> List[bool]:
    """For each scale of a checkpoint's sweep, whether its programs are
    dropped after it: after the last scale, and where the next scale runs
    another program (CFG on where it was off, or off where it was on;
    `augment.runs_cfg`). The steer and the guidance are program inputs, so
    scales that differ only in value share one program."""
    cfg = [augment.runs_cfg(use_routing_gates, s) for s in scales]
    return [i + 1 == len(cfg) or cfg[i + 1] != cfg[i] for i in range(len(cfg))]


def model_for(args, cfg, device, checkpoint: Optional[str]) -> DADD:
    """The model a checkpoint runs on: built from `--seed`, then the
    checkpoint's weights (its EMA with `--ema`) loaded."""
    model = build_model(cfg, args.dtype, tome_ratio=args.tome_ratio, tome_mode=args.tome_mode,
                        vae_quant=args.vae_quant, device=device, seed=args.seed)
    return load_params(model, checkpoint, args.ema)


def real_images(ds: LIMUCDataset, num_classes: int, max_per_class: int) -> Dict[int, np.ndarray]:
    """The first `max_per_class` images of each class in [0, 1], float32,
    as (the loader's [−1, 1] image + 1) / 2."""
    by_class: Dict[int, List[np.ndarray]] = {c: [] for c in range(num_classes)}
    for idx, (_, lbl) in enumerate(ds.samples):
        if len(by_class[lbl]) < max_per_class:
            by_class[lbl].append((ds.load(idx)["image"] + 1.0) / 2.0)
    return {c: np.stack(v) for c, v in by_class.items() if v}


def main(argv=None) -> List[EvalResult]:
    args = build_argparser().parse_args(argv)
    device = cli_device(args.device)
    cfg = load_config(args.config)
    image_size = args.image_size or cfg.dataset.image_size
    steps = args.sampling_steps or cfg.diffusion.sampling_steps
    num_classes = cfg.dataset.num_classes
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    if args.encoder_stride > 1 and not cfg.model.use_routing_gates and any(
            s != 1.0 for s in args.scales):
        raise SystemExit("--encoder-stride > 1 is incompatible with "
                         "dual-pass CFG (baseline mode with scale != 1)")

    model = model_for(args, cfg, device, args.checkpoints[0])
    ds = LIMUCDataset(Path(args.data_dir) / args.split, image_size=image_size, return_clip=True,
                      clip_size=model.clip_cfg.image_size, seed=args.seed)
    jobs = collect_jobs(ds, num_classes, args.max_per_class)
    print(f"{len(jobs)} generation jobs from {len(ds)} {args.split} images")
    real_np = real_images(ds, num_classes, args.max_per_class)
    trees = {k: load_params_npz(p) if p else None
             for k, p in (("inception", args.inception_params), ("vgg", args.vgg_params))}
    bank = FeatureBank(model, trees["inception"], trees["vgg"],
                       allow_random_backbones=args.allow_random_backbones)

    timer = PhaseTimer(device)
    results: List[EvalResult] = []
    with trace_if(out_root / "trace", enabled=args.profile):
        for i, ckpt in enumerate(args.checkpoints):
            if i:
                bank.model = model = None
                gc.collect()
                bank.model = model = model_for(args, cfg, device, ckpt)
            for scale, drop in zip(args.scales, drops_after(
                    args.scales, model.core_cfg.use_routing_gates)):
                run_name = f"{Path(ckpt).stem if ckpt else 'random'}_scale{scale}"
                run_dir = out_root / run_name
                run_dir.mkdir(parents=True, exist_ok=True)
                writer = AsyncImageWriter() if args.save_images else None
                try:
                    with timer.phase("generate"):
                        fake_np, tput = generate_all(
                            model, ds, jobs, scale, image_size, steps, args.batch_images,
                            num_classes, args.seed, writer=writer,
                            out_dir=run_dir if args.save_images else None,
                            encoder_stride=args.encoder_stride, cache_mode=args.cache_mode,
                            sampler=args.sampler)
                finally:
                    if writer:
                        writer.close()
                with timer.phase("metrics"):
                    per_class, overall = evaluate_one_run(real_np, fake_np, bank,
                                                          args.num_eval_seeds, args.seed)
                res = EvalResult(checkpoint=str(ckpt), scale=scale, per_class=per_class,
                                 overall=overall, throughput_img_s=tput,
                                 num_generated=int(sum(len(v) for v in fake_np.values())))
                results.append(res)
                with open(run_dir / "metrics.json", "w") as f:
                    json.dump(res.to_json(), f, indent=2)
                print(f"[{run_name}] {tput:.2f} img/s overall={overall}")
                if drop:
                    model.drop_programs()  # this program and its pool

    with open(out_root / "comparison.json", "w") as f:
        json.dump([r.to_json() for r in results], f, indent=2)
    print(comparison_table([r.to_json() for r in results]))
    if args.profile:
        print(f"[profile] trace → {out_root / 'trace'}\n{timer.report()}")
    print(f"Wrote {len(results)} runs → {out_root / 'comparison.json'}")
    return results


if __name__ == "__main__":
    main()
