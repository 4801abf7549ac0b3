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

Across ranks (`train/trainer.py::shard_train_state`) rank 0 writes this
one-card format, whole tensors: under DDP from its own replica; under FSDP2
every rank takes part in gathering each tensor (`parallel.mesh.full`, one
at a time, so the card holds one whole tensor beyond its shards) and rank 0
alone copies it to the host. Under tp each cut tensor (the parameter, its
EMA, both moments and the accumulated gradient) is then gathered over the
tp group (`parallel.mesh.tp_gather`; every rank takes part), net_0_proj's
halves back in the one-card order [h_0 h_1 … ; g_0 g_1 …]. A restore loads
the whole tensors on every rank and cuts them to its slices and shards, so
a one-card checkpoint resumes on any mesh, and any mesh's on one card.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..parallel.mesh import full, local, local_part, rank, tp_cuts, tp_gather, tp_slice

FILES = ("params.pt", "ema.pt", "optimizer.pt", "state.json")
MAX_TO_KEEP = 3


def saved_steps(directory: Path) -> List[int]:
    """The whole steps under a checkpoint root, in order (a `<step>.tmp`
    being written is not one)."""
    return sorted(int(p.name) for p in directory.iterdir() if p.is_dir() and p.name.isdigit())


def snapshot(state) -> Optional[Dict]:
    """A host copy of the train state: what `save` writes. Across ranks
    every rank calls it (FSDP2's shards and the tp slices are gathered) and
    only rank 0 gets the copy; the others get None."""
    from .trainer import is_sharded

    keep = rank() == 0
    cuts = tp_cuts(state.model.core)
    if not keep and not is_sharded(state) and not cuts:
        return None  # DDP: rank 0 holds the whole state itself

    def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, t in tensors.items():
            whole = full(t.detach())
            if k in cuts:
                dim, halves, cut = cuts[k]
                whole = tp_gather(whole, dim, halves, cut)
            if keep:
                out[k] = whole.to("cpu", copy=True)
        return out

    named = dict(state.model.core.named_parameters())
    opt = state.opt_state
    moments = {n: opt.adamw.state[p] for n, p in named.items() if opt.adamw.state.get(p)}
    snap = {
        "params.pt": host(named),
        "ema.pt": host(state.ema.params),
        "optimizer.pt": {"exp_avg": host({n: s["exp_avg"] for n, s in moments.items()}),
                         "exp_avg_sq": host({n: s["exp_avg_sq"] for n, s in moments.items()}),
                         "step": {n: float(s["step"]) for n, s in moments.items()},
                         "count": opt.count, "mini_step": opt.mini_step,
                         "acc": None if opt.acc is None else host(dict(zip(named, opt.acc)))},
        "state.json": {"step": int(state.step), "ema_count": int(state.ema.count),
                       "generator": state.generator.get_state().tolist()},
    }
    return snap if keep else None


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
    parameters, the EMA, AdamW's state, the counts and the generator, each
    tensor copied into the one the state holds; each whole tensor cut to
    this rank's tp slice where the UNet is cut over tp, then to its shard
    where the state is sharded."""
    named = dict(state.model.core.named_parameters())
    cuts = tp_cuts(state.model.core)

    def load(name):
        return torch.load(directory / name, map_location="cpu", weights_only=True, mmap=True)

    def sliced(name, whole):
        """`whole` cut to this rank's tp slice where `name` is cut."""
        if name not in cuts:
            return whole
        dim, halves, cut = cuts[name]
        return tp_slice(whole, dim, halves, cut.size, cut.rank)

    def mine(name, whole, like):
        """`whole` cut to `like`'s tp slice and shard, on its device."""
        return local_part(sliced(name, whole), like)

    def into(dst, name, whole):
        if isinstance(dst, DTensor):
            local(dst).copy_(local(mine(name, whole, dst)))
        else:
            dst.copy_(sliced(name, whole))

    for name, t in load("params.pt").items():
        into(named[name], name, t)
    for name, t in load("ema.pt").items():
        into(state.ema.params[name], name, t)
    # AdamW's moments, step counts and the accumulated gradients go into the
    # tensors the state holds, where it holds them: a captured train step
    # (trainer.compile_train_step) reads them at their addresses. A state
    # that has not stepped yet gets new ones, on the parameters' device
    # (the step count there too where AdamW is capturable).
    opt, saved = state.opt_state, load("optimizer.pt")
    on_device = opt.adamw.defaults["capturable"]
    replaced = any(p not in saved["step"] and opt.adamw.state.get(named[p])
                   for p in named)
    for name in named:
        if name not in saved["step"]:
            opt.adamw.state.pop(named[name], None)
    for name, step in saved["step"].items():
        p = named[name]
        s = opt.adamw.state.get(p)
        if s:
            s["step"].fill_(step)
            into(s["exp_avg"], name, saved["exp_avg"][name])
            into(s["exp_avg_sq"], name, saved["exp_avg_sq"][name])
        else:
            replaced = True
            opt.adamw.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32,
                                     device=local(p).device if on_device else "cpu"),
                "exp_avg": mine(name, saved["exp_avg"][name], p).clone(),
                "exp_avg_sq": mine(name, saved["exp_avg_sq"][name], p).clone()}
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    if saved["acc"] is None:
        if opt.acc is not None:
            torch._foreach_zero_([local(a) for a in opt.acc])
    elif opt.acc is None:
        replaced = True
        opt.acc = [mine(n, saved["acc"][n], p).clone() for n, p in named.items()]
    else:
        for a, n in zip(opt.acc, named):
            into(a, n, saved["acc"][n])
    if replaced:
        # a program captured before would write the tensors that were replaced
        state.drop_programs()
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
        background; False (nothing saved) for a step already saved. Across
        ranks every rank calls it and rank 0 writes."""
        if step in self._steps:
            return False
        snap = snapshot(state)
        self.wait()
        with self._lock:
            self._steps.append(step)
        if snap is None:  # rank 0 writes it
            return True

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
