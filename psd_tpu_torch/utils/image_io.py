"""Image saving helpers: PNG sequences, the progression grid, BMP writes and
the augment factory's asynchronous writer.

The port's own copy of `psd_tpu/utils/image_io.py`, in numpy and PIL, with
psd_tpu's native host kernels (`data/native.py`): the fused clip-scale-round
of `to_uint8` and the BMP writer of `save_image`. The native library builds
at first use and raises if it cannot; there is no numpy fallback.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from ..data import native


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] → uint8: clip, ·255, + 0.5, truncate, in
    float32 (the native kernel; other float dtypes are cast to float32)."""
    return native.to_uint8(np.asarray(img, np.float32))


def save_image(img: np.ndarray, path: str | Path) -> None:
    """One (H, W, 3) image in [0, 1], in the format the suffix names; a
    `.bmp` through the native writer, as psd_tpu's augment factory writes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    u8 = to_uint8(img)
    if path.suffix.lower() == ".bmp":
        native.write_bmp(path, u8)
        return
    Image.fromarray(u8).save(path)


def save_sequence(images: np.ndarray, labels: Sequence[float], out_dir: str | Path,
                  prefix: str = "mes") -> List[Path]:
    """(N, H, W, 3) images in [0, 1] → `<prefix>_<label:.2f>.png` each."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for img, lbl in zip(images, labels):
        p = out_dir / f"{prefix}_{lbl:.2f}.png"
        save_image(img, p)
        paths.append(p)
    return paths


def progression_grid(images: np.ndarray, labels: Sequence[float], path: str | Path,
                     reference: Optional[np.ndarray] = None, pad: int = 4,
                     label_band: int = 20) -> Path:
    """A horizontal strip of (N, H, W, 3) images in [0, 1] with MES labels,
    the structure `reference` first when given."""
    imgs = [to_uint8(im) for im in images]
    if reference is not None:
        imgs = [to_uint8(reference)] + imgs
        labels = ["ref"] + [f"{v:.2f}" for v in labels]
    else:
        labels = [f"{v:.2f}" for v in labels]
    h, w = imgs[0].shape[:2]
    n = len(imgs)
    grid = Image.new("RGB", (n * w + (n + 1) * pad, h + 2 * pad + label_band), (255, 255, 255))
    draw = ImageDraw.Draw(grid)
    for i, (im, lbl) in enumerate(zip(imgs, labels)):
        x = pad + i * (w + pad)
        grid.paste(Image.fromarray(im), (x, pad))
        draw.text((x + 2, h + pad + 2), f"MES {lbl}", fill=(0, 0, 0))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    grid.save(path)
    return path


class AsyncImageWriter:
    """`save_image` in a thread pool, so the host's disk writes overlap the
    card's next batch (the augment factory and the evaluation sweep)."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=8)
        self._futures = []

    def submit(self, img: np.ndarray, path: str | Path) -> None:
        self._futures.append(self._pool.submit(save_image, img, path))

    def flush(self) -> None:
        """Wait for every write so far; a failed write raises here."""
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown()
