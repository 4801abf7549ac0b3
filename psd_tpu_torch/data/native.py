"""ctypes binding of the host-side image kernels in `native/limuc_io.cpp`.

Counterpart of `psd_tpu/data/native.py`, over the same C source, which the
port compiles and does not change. The loader calls two of its kernels: a
Pillow-exact bilinear resize and the fused uint8 → float32 normalize. The
library builds with `g++` at first use, never
at import, into `build/psd_tpu_torch/native/<hash>/` under the checkout
(git-ignored; the hash covers the source, the flags and the CPU, since
psd_tpu's flags include `-march=native`), with psd_tpu's flags. A failed build raises: there is no fallback, since psd_tpu's numpy
path is a different computation.

    python3 -c "from psd_tpu_torch.data import native; native.library()"
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "limuc_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "psd_tpu_torch" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu() -> bytes:
    """What `-march=native` compiles for: the CPU's model and flags, so a
    checkout copied to another machine builds its own library."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        info = []
    keep = [line for line in info if line.startswith(("model name", "flags"))][:2]
    return (platform.machine() + "\n".join(keep)).encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _cpu()).hexdigest()
    return BUILD_ROOT / digest[:16] / "liblimuc_io.so"


def _build(path: Path) -> None:
    """g++ into a temporary name beside `path`, then rename: processes that
    build at once each load a whole library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            u8p, f32p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
            lib.normalize_u8_to_f32.argtypes = [u8p, f32p, i, i, f32p, f32p, ctypes.c_float]
            for void in (lib.resize_bilinear_u8, lib.normalize_u8_to_f32):
                void.restype = None
            _lib = lib
    return _lib


def _hwc(img: np.ndarray, dtype) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype)
    if img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got shape {img.shape}")
    return img


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 (H, W, C) → uint8 (oh, ow, C), byte-equal to PIL's BILINEAR."""
    img = _hwc(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    library().resize_bilinear_u8(_u8(img), h, w, c, _u8(out), oh, ow)
    return out


def normalize(img_u8: np.ndarray, mean, std, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 (H, W, C) → float32 (x·scale − mean)/std in one pass."""
    img_u8 = _hwc(img_u8, np.uint8)
    h, w, c = img_u8.shape
    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    out = np.empty((h, w, c), np.float32)
    library().normalize_u8_to_f32(_u8(img_u8), _f32(out), h * w, c, _f32(mean), _f32(std), scale)
    return out

