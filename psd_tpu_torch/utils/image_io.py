"""Image saving helpers: PNG sequences and the progression grid.

The port's own copy of `psd_tpu/utils/image_io.py`, in numpy and PIL. Where
psd_tpu calls its native host kernels (`psd_tpu/data/native.py`: the fused
clip-scale-round and the BMP writer), this copy runs their numpy and PIL
fallbacks, the same arithmetic; the native kernels come with the data
pipeline's port.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] → uint8, rounding half up."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_image(img: np.ndarray, path: str | Path) -> None:
    """One (H, W, 3) image in [0, 1], in the format the suffix names."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


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
