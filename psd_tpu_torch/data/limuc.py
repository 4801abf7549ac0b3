"""LIMUC data pipeline: a class-per-directory image tree, PIL augments, the
SD and CLIP views of each image, inverse-frequency class-balanced sampling
and a threaded prefetching loader.

Counterpart of `psd_tpu/data/limuc.py`, with its semantics:
  * the class directories in sorted order, each one's images sorted;
  * per item: PIL augment (center crop → hflip p 0.5 → rotation ±deg →
    perspective p 0.3) → the native bilinear resize to (image_size)² → SD
    normalize to [−1, 1] in one native pass; the CLIP view from the same
    resized uint8 image (`preprocess.clip_preprocess`, where psd_tpu hands
    `CLIPImageProcessor` that image as floats in [0, 1], which it turns
    back into the same uint8 image);
  * sample weights 1/(count + 1e-8) by class, normalized;
  * the same numpy `default_rng` streams: the dataset's (shared with its
    augment) and the loader's;
  * threads, not worker processes; NHWC arrays. An item that fails to load
    raises in the consumer (psd_tpu's loader ends the epoch there).

The augment draws from the dataset's one generator, shared by the loader's
threads: with augmentation on and more than one thread, which image gets
which draw depends on the threads' order, as in psd_tpu.

Items are float32 NHWC: image (S, S, 3) in [−1, 1], label, clip_image
(224, 224, 3) CLIP-normalized.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from . import native
from .preprocess import clip_preprocess

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


@dataclass
class AugmentConfig:
    center_crop: Optional[int] = 224
    flip: bool = True
    rotation: float = 5.0
    perspective: float = 0.2
    perspective_p: float = 0.3


def _perspective_coeffs(src, dst):
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    A = np.asarray(a, dtype=np.float64)
    b = np.asarray(dst, dtype=np.float64).reshape(8)
    return np.linalg.solve(A, b).tolist()


class PILAugment:
    """Train-time PIL augments, their draws from `rng`."""

    def __init__(self, cfg: AugmentConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng

    def __call__(self, img: Image.Image) -> Image.Image:
        c = self.cfg
        if c.center_crop:
            w, h = img.size
            s = c.center_crop
            left, top = max((w - s) // 2, 0), max((h - s) // 2, 0)
            img = img.crop((left, top, left + min(s, w), top + min(s, h)))
        if c.flip and self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if c.rotation > 0:
            deg = float(self.rng.uniform(-c.rotation, c.rotation))
            img = img.rotate(deg, resample=Image.NEAREST, expand=False)
        if c.perspective > 0 and self.rng.random() < c.perspective_p:
            img = self._perspective(img, c.perspective)
        return img

    def _perspective(self, img: Image.Image, scale: float) -> Image.Image:
        """torchvision RandomPerspective-style random corner displacement."""
        w, h = img.size
        dx, dy = scale * w / 2, scale * h / 2
        r = self.rng
        tl = (r.uniform(0, dx), r.uniform(0, dy))
        tr = (w - r.uniform(0, dx), r.uniform(0, dy))
        br = (w - r.uniform(0, dx), h - r.uniform(0, dy))
        bl = (r.uniform(0, dx), h - r.uniform(0, dy))
        coeffs = _perspective_coeffs([(0, 0), (w, 0), (w, h), (0, h)], [tl, tr, br, bl])
        return img.transform((w, h), Image.PERSPECTIVE, coeffs, Image.BILINEAR)


class LIMUCDataset:
    """Class-per-directory image dataset with the SD and CLIP views."""

    def __init__(self, root: str | Path, image_size: int = 256,
                 augment: Optional[AugmentConfig] = None, return_clip: bool = True,
                 clip_size: int = 224, seed: int = 0):
        self.root = Path(root)
        self.image_size = image_size
        self.return_clip = return_clip
        self.clip_size = clip_size
        self.rng = np.random.default_rng(seed)
        self.augment = PILAugment(augment, self.rng) if augment else None
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"No class directories under {self.root}")
        self.class_to_idx: Dict[str, int] = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[Path, int]] = [
            (f, self.class_to_idx[c]) for c in classes
            for f in sorted((self.root / c).iterdir()) if f.suffix.lower() in IMAGE_EXTS]

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def class_counts(self) -> np.ndarray:
        counts = np.zeros(len(self.class_to_idx), np.int64)
        for _, lbl in self.samples:
            counts[lbl] += 1
        return counts

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        path, label = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.augment is not None:
            img = self.augment(img)
        u8 = native.resize_bilinear(np.asarray(img, np.uint8), self.image_size, self.image_size)
        out = {"image": native.normalize(u8, mean=[0.5] * 3, std=[0.5] * 3),
               "label": np.float32(label)}
        if self.return_clip:
            out["clip_image"] = clip_preprocess(Image.fromarray(u8), self.clip_size)
        return out

    def balanced_weights(self) -> np.ndarray:
        """Per-sample inverse-frequency weights, summing to 1."""
        w = 1.0 / (self.class_counts.astype(np.float64) + 1e-8)
        sw = w[np.asarray([lbl for _, lbl in self.samples])]
        return sw / sw.sum()


class DataLoader:
    """Batches from a thread pool, `prefetch` of them ahead, in a thread."""

    def __init__(self, dataset: LIMUCDataset, batch_size: int, shuffle: bool = True,
                 class_balanced: bool = True, num_threads: int = 8, prefetch: int = 2,
                 drop_last: bool = True, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.class_balanced = class_balanced
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.ds)
        if self.class_balanced:
            return self.rng.choice(n, size=n, replace=True, p=self.ds.balanced_weights())
        idx = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        items = list(pool.map(self.ds.load, indices[b * self.batch_size:
                                                                    (b + 1) * self.batch_size]))
                        q.put({k: np.stack([it[k] for it in items]) for k in items[0]})
            except Exception as e:  # an item that failed to load: raised to the consumer
                q.put(e)
            finally:
                q.put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
