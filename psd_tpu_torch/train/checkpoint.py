"""Checkpoints of the train state, in the port's own torch format.

Counterpart of `psd_tpu/train/checkpoint.py` (orbax there, which cannot be
read without JAX). One directory per step under the manager's root:

    <root>/<step>/params.pt     the fp32 master parameters, name → tensor
    <root>/<step>/ema.pt        the EMA's parameters, name → tensor
    <root>/<step>/optimizer.pt  per parameter AdamW's moments and step
                                count; the optimizer step count, the
                                micro-step and accumulated gradients
    <root>/<step>/state.json    the step, the EMA count and the state of the
                                draws' generator

A step is written as `<root>/<step>.tmp` and renamed once whole, so every
directory named by a step holds all four files. The infer CLI reads
`params.pt` or `ema.pt` alone (`load_weights`), not the whole state.

`save` copies the state to host memory on the caller's thread (the train
step updates the parameters in place, so the copy must exist before the
next step) and writes it in a background thread, as orbax saves
asynchronously; `wait` joins the writes. After each write the oldest steps
beyond `MAX_TO_KEEP` are deleted (psd_tpu's default). The CLI resumes
through `restore_into(state, step_dir(path))`.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

FILES = ("params.pt", "ema.pt", "optimizer.pt", "state.json")
MAX_TO_KEEP = 3


def saved_steps(directory: Path) -> List[int]:
    """The whole steps under a checkpoint root, in order (a `<step>.tmp`
    being written is not one)."""
    return sorted(int(p.name) for p in directory.iterdir() if p.is_dir() and p.name.isdigit())


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def snapshot(state) -> Dict:
    """A host copy of the train state: what `save` writes."""
    core = state.model.core
    names = {p: n for n, p in core.named_parameters()}
    opt = state.opt_state
    adam = {"exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for p, s in opt.adamw.state.items():
        if s:
            adam["exp_avg"][names[p]] = s["exp_avg"]
            adam["exp_avg_sq"][names[p]] = s["exp_avg_sq"]
            adam["step"][names[p]] = float(s["step"])
    acc = None if opt.acc is None else dict(zip(names.values(), opt.acc))
    return {
        "params.pt": _host(dict(core.named_parameters())),
        "ema.pt": _host(state.ema.params),
        "optimizer.pt": {"exp_avg": _host(adam["exp_avg"]),
                         "exp_avg_sq": _host(adam["exp_avg_sq"]), "step": adam["step"],
                         "count": opt.count, "mini_step": opt.mini_step,
                         "acc": None if acc is None else _host(acc)},
        "state.json": {"step": int(state.step), "ema_count": int(state.ema.count),
                       "generator": state.generator.get_state().tolist()},
    }


def nbytes(snap: Dict) -> int:
    """The bytes of the tensors in a snapshot."""
    def size(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(size(v) for v in x.values())
        return 0

    return sum(size(v) for v in snap.values())


def _write(directory: Path, snap: Dict) -> None:
    tmp = directory.with_name(directory.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name, obj in snap.items():
        if name.endswith(".json"):
            (tmp / name).write_text(json.dumps(obj))
        else:
            torch.save(obj, tmp / name)
    tmp.rename(directory)


@torch.no_grad()
def restore_into(state, directory: Path):
    """Load the step directory `directory` into `state` in place: the
    parameters, the EMA, AdamW's state, the counts and the generator."""
    core = state.model.core
    named = dict(core.named_parameters())

    def load(name):
        return torch.load(directory / name, map_location="cpu", weights_only=True, mmap=True)

    for name, t in load("params.pt").items():
        named[name].copy_(t)
    for name, t in load("ema.pt").items():
        state.ema.params[name].copy_(t)
    opt, saved = state.opt_state, load("optimizer.pt")
    opt.adamw.state.clear()
    for name, step in saved["step"].items():
        p = named[name]
        opt.adamw.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                              "exp_avg": saved["exp_avg"][name].to(p.device),
                              "exp_avg_sq": saved["exp_avg_sq"][name].to(p.device)}
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    opt.acc = None if saved["acc"] is None else [saved["acc"][n].to(p.device)
                                                 for n, p in named.items()]
    meta = json.loads((directory / "state.json").read_text())
    state.step, state.ema.count = meta["step"], meta["ema_count"]
    state.generator.set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
    return state


def step_dir(path: str | Path) -> Path:
    """A step directory, or a root → its latest step's directory."""
    path = Path(path)
    if (path / "state.json").exists():
        return path
    steps = saved_steps(path) if path.is_dir() else []
    if not steps:
        raise FileNotFoundError(f"No checkpoint found in {path}")
    return path / str(steps[-1])


def load_weights(path: str | Path, ema: bool = False) -> Dict[str, torch.Tensor]:
    """The parameters (or with `ema` the EMA's) of a step directory or of a
    root's latest step, name → CPU tensor."""
    return torch.load(step_dir(path) / ("ema.pt" if ema else "params.pt"), map_location="cpu",
                      weights_only=True, mmap=True)


class CheckpointManager:
    def __init__(self, directory: str | Path):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._steps = saved_steps(self.directory)
        self._lock = threading.Lock()  # _steps: the writer trims, callers append and read
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Optional[Tuple[int, float]] = None  # (bytes, seconds) of the last write

    def save(self, step: int, state) -> bool:
        """Snapshot `state` to host memory now and write it as `step` in the
        background; False (nothing saved) for a step already saved."""
        if step in self._steps:
            return False
        snap = snapshot(state)
        self.wait()
        with self._lock:
            self._steps.append(step)

        def write():
            t0 = time.perf_counter()
            try:
                _write(self.directory / str(step), snap)
                self.last_save = (nbytes(snap), time.perf_counter() - t0)
                with self._lock:
                    old = self._steps[:-MAX_TO_KEEP]
                    del self._steps[:-MAX_TO_KEEP]
                for s in old:
                    shutil.rmtree(self.directory / str(s), ignore_errors=True)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}")
        self._writer.start()
        return True

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return self._steps[-1] if self._steps else None

    def wait(self) -> None:
        """Block until the background write is done; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def resolve_resume_path(resume: Optional[str], ckpt_root: str | Path) -> Optional[Path]:
    """psd_tpu's semantics: None for no resume; "last" → the checkpoint
    root (its latest step); else the path, which must exist."""
    if not resume:
        return None
    if resume == "last":
        root = Path(ckpt_root)
        if not root.exists():
            raise FileNotFoundError(f"No checkpoint directory at {root}")
        return root
    p = Path(resume)
    if not p.exists():
        raise FileNotFoundError(f"Checkpoint not found: {p}")
    return p
