"""Build, load and count the hand-written CUDA kernels.

The kernels (`csrc/*.cu`) compile with `nvcc` for `sm_90a`, one `nvcc`
process per source, all started together, then link into one shared library
with a plain C interface, loaded with `ctypes`. The build runs at first use,
never at import, into `build/psd_tpu_torch/<hash>/` under the checkout
(git-ignored); the hash covers the sources and the flags, so an edited
source rebuilds and an unchanged one loads in milliseconds.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on a non-zero code. A refused launch (too many threads, too much
shared memory) never runs and would not show up in a later synchronize.

`launch_counts` holds one plain integer per kernel, bumped by each wrapper
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. `attention_head_dims` counts the
attention kernel's launches by head dim (D=512 is the VAE mid-block). Under
CUDA graphs (`diffusion/graphs.py`) the counts are host counts: a wrapper
runs, and counts, when the body runs eagerly before capture and when its
launch is captured; a replay runs no wrapper and counts nothing. Each
captured program keeps the count of its capture, what every replay of it
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "psd_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

launch_counts: Counter = Counter({"attention": 0, "attention_bwd": 0, "split3": 0,
                                  "ln_proj": 0, "ln_geglu": 0, "gn_proj": 0,
                                  "attention_q8": 0})
attention_head_dims: Counter = Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, lse (or null), B, Sq, Sk, H, D, scale, stream
    "psd_attention_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, D, scale, stream
    "psd_attention_bwd": [_P] * 10 + [_I] * 5 + [_F, _P],
    # qq, sq, kq, sk, v (bf16) or vq (int8), sv (or null), out, B, S, H, D,
    # scale·log2e, pv8, stream
    "psd_attention_q8_fwd": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    # x, gn_w, gn_b, w, bias, out, B, S, C, N, stream
    "psd_gn_proj_fwd": [_P] * 6 + [_I] * 4 + [_P],
    # q, ka, va, kd, vd, kl, vl, out, B, S, H, D, Ka, Kd, Kl,
    # g_anat, g_dis, delta, scale, rows, heads, stages, blocks an SM
    # (split3_plan), stream
    "psd_split3_fwd": [_P] * 8 + [_I] * 7 + [_F] * 4 + [_I] * 4 + [_P],
    # x, ln_w, ln_b, w0, w1, w2, o0, o1, o2, stats, n_out, M, C, N, eps, stream
    "psd_ln_proj_fwd": [_P] * 10 + [_I] * 4 + [_F, _P],
    # x, ln_w, ln_b, w, b, out, stats, M, C, N, eps, stream
    "psd_ln_geglu_fwd": [_P] * 7 + [_I] * 3 + [_F, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    attention_head_dims.clear()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home) / "bin" / "nvcc"
        if home and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels build "
                           "only on a machine with the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library if it is not built yet."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libpsd_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    jobs = []  # one nvcc per source, all running at once
    for src in sorted(CSRC.glob("*.cu")):
        fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out[-4000:])
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not failed:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", tmp,
               *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr[-4000:])
    (out_dir / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        os.unlink(obj)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel (it fills `torch.empty` through `data_ptr`, with
    no autograd node) refuses an input that wants a gradient, which it would
    otherwise drop without a word. Training mode routes around such kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward, but an input requires grad: differentiate "
                           "inside core.mode.training_mode(), as the train step does")


def require_cuda_bf16(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev, f"{name}: all operands on one CUDA device")
        require(t.dtype == torch.bfloat16, f"{name}: bf16 operands, got {t.dtype}")
        require(t.is_contiguous(), f"{name}: contiguous operands")
        require(t.data_ptr() % 32 == 0, f"{name}: 32-byte aligned operands")


def require_cuda_f32(name: str, dev: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        require(t.device == dev and t.dtype == torch.float32 and t.is_contiguous(),
                f"{name}: fp32 contiguous vectors on {dev}")
