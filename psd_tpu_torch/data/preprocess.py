"""CLIP's image preprocessing in PIL and numpy.

`CLIPImageProcessor(size={"shortest_edge": size}, crop_size=size)`'s
computation, so the port needs no `transformers` (the GPU machine may lack
it): the shorter edge resized to `size` (bicubic), the center crop, ·1/255
in float64 then float32, (x − mean)/std in float32. The infer CLI and the
LIMUC loader both take it from here.

The evaluation sweep hands the processor float images in [0, 1]
(`do_rescale=False`); transformers then turns each into the uint8 image it
resizes (`processor_uint8`): ·255 in float64, cast to float32, then
truncated to uint8, except that an image whose values are all integers (all
0 and 1, say) is cast as it is and never rescaled, so its pixels stay 0..1
through the normalize (`clip_preprocess(..., rescale=False)`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

# OpenAI CLIP's pixel statistics (CLIPImageProcessor's defaults)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(image: Image.Image, size: int = 224, rescale: bool = True) -> np.ndarray:
    """A PIL image → (size, size, 3) float32 CLIP pixels: the shorter edge
    resized to `size` (bicubic, the longer int(size·long/short)), the
    center crop, ·1/255 (in float64, then float32; skipped with `rescale`
    off), (x − mean)/std."""
    image = image.convert("RGB")
    w, h = image.size
    long = int(size * max(w, h) / min(w, h))
    new_w, new_h = (size, long) if w <= h else (long, size)
    arr = np.asarray(image.resize((new_w, new_h), Image.BICUBIC))
    top, left = (new_h - size) // 2, (new_w - size) // 2
    arr = arr[top:top + size, left:left + size]
    x = (arr.astype(np.float64) * (1 / 255)).astype(np.float32) if rescale else (
        arr.astype(np.float32))
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def processor_uint8(image: np.ndarray) -> Tuple[np.ndarray, bool]:
    """A float (H, W, 3) image → (the uint8 image `CLIPImageProcessor` resizes,
    whether it rescaled): transformers' `to_pil_image` as its resize calls
    it. Values all (close to) integers in [0, 255] are cast as they are;
    otherwise values in [0, 1] are ·255 in float64, cast to float32 and
    truncated; anything else raises, as there."""
    image = np.asarray(image)
    if np.allclose(image, image.astype(int)):
        if not (np.all(image >= 0) and np.all(image <= 255)):
            raise ValueError(f"image values outside [0, 255]: [{image.min()}, {image.max()}]")
        return image.astype(np.uint8), False
    if not (np.all(image >= 0) and np.all(image <= 1)):
        raise ValueError(f"image values outside [0, 1]: [{image.min()}, {image.max()}]")
    return (image.astype(np.float64) * 255).astype(np.float32).astype(np.uint8), True


def clip_preprocess_float(image: np.ndarray, size: int = 224) -> np.ndarray:
    """A float (H, W, 3) image in [0, 1] → `CLIPImageProcessor(...)(images=
    image, do_rescale=False)`'s pixels, (size, size, 3) float32."""
    u8, rescaled = processor_uint8(image)
    return clip_preprocess(Image.fromarray(u8), size, rescale=rescaled)
