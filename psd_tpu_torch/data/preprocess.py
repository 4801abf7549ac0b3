"""CLIP's image preprocessing in PIL and numpy.

`CLIPImageProcessor(size={"shortest_edge": size}, crop_size=size)`'s
computation, so the port needs no `transformers` (the GPU machine may lack
it): the shorter edge resized to `size` (bicubic), the center crop, ·1/255
in float64 then float32, (x − mean)/std in float32. The infer CLI and the
LIMUC loader both take it from here.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

# OpenAI CLIP's pixel statistics (CLIPImageProcessor's defaults)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(image: Image.Image, size: int = 224) -> np.ndarray:
    """A PIL image → (size, size, 3) float32 CLIP pixels: the shorter edge
    resized to `size` (bicubic, the longer int(size·long/short)), the
    center crop, ·1/255 (in float64, then float32), (x − mean)/std."""
    image = image.convert("RGB")
    w, h = image.size
    long = int(size * max(w, h) / min(w, h))
    new_w, new_h = (size, long) if w <= h else (long, size)
    arr = np.asarray(image.resize((new_w, new_h), Image.BICUBIC))
    top, left = (new_h - size) // 2, (new_w - size) // 2
    arr = arr[top:top + size, left:left + size]
    x = (arr.astype(np.float64) * (1 / 255)).astype(np.float32)
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
