"""Fit a LEACE disease-erasure projection from train-set image embeddings,
without JAX.

The port's counterpart of `scripts/compute_leace_projection.py`, with its
flags, its fp32 model, its batching and its four printed statistics: the
first `--max-images` train images, `--batch-size` at a time, go through the
CLIP tower and the image projection (`DADDCore.image_projection`); then
`fit_leace` fits the between-class-scatter null projection of `--rank`
directions over all of them and prints the inter-class mean distances
before and after as its self-check. The npz is psd_tpu's format, which
`python -m psd_tpu_torch.pipelines.infer --leace` reads (and psd_tpu's
infer too).

    python scripts/torch_compute_leace_projection.py --config configs/train.yaml \\
        --checkpoint runs/train/checkpoints --data-dir dataset/limuc \\
        --output leace_projection.npz

`--data-dir` holds `train/<class>/*.png`. Without `--checkpoint` the weights
are drawn from `--seed` (smoke mode), as in psd_tpu's script. `--device` as
the port's CLIs take it: the card by default, raising without one; `--device
cpu` runs on the CPU. CLIP's 257 tokens take the plain attention path on the
card, as in psd_tpu.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from psd_tpu_torch.conditioning.leace import fit_leace, save_leace  # noqa: E402
from psd_tpu_torch.core.config import load_config  # noqa: E402
from psd_tpu_torch.data.limuc import LIMUCDataset  # noqa: E402
from psd_tpu_torch.pipelines.common import add_device_arg, build_model, cli_device  # noqa: E402
from psd_tpu_torch.pipelines.infer import load_params  # noqa: E402


def main(argv=None) -> dict:
    """Run the script; → the fitted projection (with its `stats`)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--rank", type=int, default=1)
    p.add_argument("--max-images", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="leace_projection.npz")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    model = build_model(cfg, "fp32", device=cli_device(args.device), seed=args.seed)
    model = load_params(model, args.checkpoint)
    ds = LIMUCDataset(Path(args.data_dir) / "train", image_size=cfg.dataset.image_size,
                      return_clip=True, clip_size=model.clip_cfg.image_size, seed=args.seed)

    embeds, labels = [], []
    n = min(args.max_images, len(ds))
    with torch.inference_mode():
        for b in range(0, n, args.batch_size):
            items = [ds.load(i) for i in range(b, min(b + args.batch_size, n))]
            feats = model.encode_image_clip(np.stack([it["clip_image"] for it in items]))
            embeds.append(model.core.image_projection(feats).float().cpu().numpy())
            labels.extend(float(it["label"]) for it in items)

    embeddings = np.concatenate(embeds, axis=0)
    labels = np.asarray(labels)
    leace = fit_leace(embeddings, labels, rank=args.rank)
    s = leace["stats"]
    print(f"Class counts: {np.bincount(labels.astype(int)).tolist()}")
    print(f"Explained variance ratio: {s['explained_variance']:.4f}")
    print(f"Max inter-class mean distance BEFORE: {s['dist_before']:.4f}")
    print(f"Max inter-class mean distance AFTER:  {s['dist_after']:.4f}")
    save_leace(leace, args.output)
    print(f"Saved → {args.output}")
    return leace


if __name__ == "__main__":
    main()
