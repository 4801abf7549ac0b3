"""MES classification dataset: the synthetic-only, class-balanced train split.

Counterpart of `psd_tpu/data/classification.py`, with its semantics and
its numpy `default_rng` stream (one generator, seeded, shared by the
balancing, the augments and the shuffle):
  * the train split keeps only files whose name contains "generated" (the
    augment factory's output, `pipelines/augment.py`) unless
    `synthetic_only_train` is off, and draws every class down to the
    smallest class's count (`rng.choice` without replacement, kept in file
    order);
  * val and test take the real images unfiltered;
  * train augments in PIL, in this draw order: left-right flip (p 0.5),
    top-bottom flip (p 0.5), a bilinear rotation by U(−15, 15)°, brightness
    and contrast each by 1 + U(−0.2, 0.2);
  * the native Pillow-exact bilinear resize and the fused ImageNet
    normalize (`data/native.py`); items are float32 (S, S, 3) NHWC and an
    int32 label.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image, ImageEnhance

from ..models.vgg import IMAGENET_MEAN, IMAGENET_STD
from . import native
from .limuc import IMAGE_EXTS


class MESClassificationDataset:
    def __init__(self, root: str | Path, split: str = "train", image_size: int = 224,
                 synthetic_only_train: bool = True, seed: int = 42):
        self.root = Path(root) / split
        self.split = split
        self.image_size = image_size
        self.augment = split == "train"
        self.rng = np.random.default_rng(seed)

        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        by_class: Dict[int, List[Path]] = {i: [] for i in range(len(classes))}
        for c in classes:
            for f in sorted((self.root / c).iterdir()):
                if f.suffix.lower() not in IMAGE_EXTS:
                    continue
                if split == "train" and synthetic_only_train and "generated" not in f.name:
                    continue
                by_class[self.class_to_idx[c]].append(f)

        if split == "train":
            counts = {c: len(v) for c, v in by_class.items() if v}
            if counts:
                m = min(counts.values())
                for c in by_class:
                    if len(by_class[c]) > m:
                        idx = self.rng.choice(len(by_class[c]), m, replace=False)
                        by_class[c] = [by_class[c][i] for i in sorted(idx)]

        self.samples: List[Tuple[Path, int]] = [
            (f, c) for c, files in by_class.items() for f in files]

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def class_counts(self) -> np.ndarray:
        counts = np.zeros(len(self.class_to_idx), np.int64)
        for _, c in self.samples:
            counts[c] += 1
        return counts

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        path, label = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.augment:
            if self.rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.rng.random() < 0.5:
                img = img.transpose(Image.FLIP_TOP_BOTTOM)
            img = img.rotate(float(self.rng.uniform(-15, 15)), resample=Image.BILINEAR)
            img = ImageEnhance.Brightness(img).enhance(1.0 + self.rng.uniform(-0.2, 0.2))
            img = ImageEnhance.Contrast(img).enhance(1.0 + self.rng.uniform(-0.2, 0.2))
        u8 = native.resize_bilinear(np.asarray(img, np.uint8), self.image_size, self.image_size)
        arr = native.normalize(u8, mean=IMAGENET_MEAN, std=IMAGENET_STD)
        return {"image": arr, "label": np.int32(label)}

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of stacked items, shuffled by the dataset's generator."""
        idx = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(idx)
        nb = len(self) // batch_size if drop_last else -(-len(self) // batch_size)
        for b in range(nb):
            items = [self.load(i) for i in idx[b * batch_size:(b + 1) * batch_size]]
            yield {"image": np.stack([it["image"] for it in items]),
                   "label": np.stack([it["label"] for it in items])}
