"""Captured programs: a served batch, or a train step, as one CUDA graph,
replayed.

Counterpart of psd_tpu's jitted `DADD.generate` and `DADD.sample`
(`psd_tpu/diffusion/dadd.py:547-629`, `_get_jitted_sample`,
`_get_jitted_generate`) and of its jitted train step
(`psd_tpu/train/trainer.py::compile_train_step`). PyTorch runs eagerly, so
a batch enqueues each of its ops from Python (≈ 1.5k an eps, ≈ 17k a train
step); a `CapturedProgram` records them once into a `torch.cuda.CUDAGraph`
and replays the graph, one launch a batch or a step.

  * A program is captured once a key (`program_key`: its kind, the input
    shapes and dtypes, the static knobs, and `core.mode.snapshot()`, since
    the graph bakes in the kill switches and the training flag it was
    captured under) and replayed after. Runtime scalars are inputs, not
    knobs: the sampler's steer (δ) and guidance enter as 0-d fp32 tensors,
    copied in like x0, and the kernels read them from device memory, so a
    sweep over either replays one program (psd_tpu traces both).
  * Before capture the body runs once eagerly on a side stream. That builds
    the kernel library (`ops/kernels.py`), cuBLAS/cuDNN plans and
    `split3_plan`'s cache, so nothing compiles or autotunes under capture.
  * Capture runs in `thread_local` error mode: the server captures on its
    worker thread while client threads run.
  * The kernel wrappers' host counters (`ops/kernels.py::launch_counts`)
    advance at that eager run and at capture, never at replay. `launches`
    keeps the capture's own count, what each replay launches.
  * A call copies its inputs into the static inputs, replays on the
    caller's current stream and copies the static output into a fresh
    tensor on that stream, so a batch still in flight keeps its output
    when the next replay overwrites the static one. An event orders a
    replay after the previous call's copy-out, whatever stream that ran on.
  * A body that updates state in place (`stateful`: the train step, which
    writes the parameters, AdamW's moments and the EMA) runs its warm-up
    as its first call: that eager run is the step, its output
    `first_output` that call's result, and the capture after it records
    without running, so no step runs twice. Such programs may share one
    graph pool (`pool`, `torch.cuda.graph_pool_handle()`), as the
    accumulating step's micro-step and applying step do: they never run at
    once, and neither reads the other's pool tensors.
  * An output is a tensor or a dict of tensors (the step's metrics).
  * No fallback: a failed warm-up, capture or replay raises.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.mode import snapshot
from ..ops import kernels


Output = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _clone(out: Output) -> Output:
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()


def program_key(kind: str, inputs: Sequence[torch.Tensor], **knobs) -> Tuple:
    """A captured program's cache key: its kind, each input's shape and
    dtype, the static knobs (sorted by name) and the mode flags in force
    (`core.mode.snapshot()`). Equal arguments under equal flags give equal
    keys."""
    return (kind, tuple((tuple(t.shape), t.dtype) for t in inputs),
            tuple(sorted(knobs.items())), snapshot())


class CapturedProgram:
    """`body(*inputs) -> output` captured in one CUDA graph on the inputs'
    device; calling it with inputs of the capture's shapes replays it.

    `warmup_s`, `capture_s` and `instantiate_s` are the host seconds of the
    eager run, of recording the body under capture, and of ending the
    capture (instantiation); `launches` counts the hand-written kernels one
    replay launches, `replays` the replays so far."""

    def __init__(self, body: Callable[..., Output], inputs: Sequence[torch.Tensor],
                 stateful: bool = False, pool=None):
        dev = inputs[0].device
        kernels.require(dev.type == "cuda", "CapturedProgram: inputs on a CUDA device")
        self.device = dev
        self.inputs = [t.clone() for t in inputs]
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            warm = body(*self.inputs)
        side.synchronize()
        self.first_output = warm if stateful else None
        del warm
        t1 = time.perf_counter()
        before = Counter(kernels.launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.output = body(*self.inputs)
            t2 = time.perf_counter()
        self.warmup_s, self.capture_s = t1 - t0, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        self.launches = Counter({k: n - before[k] for k, n in kernels.launch_counts.items()
                                 if n > before[k]})
        self.replays = 0
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None

    def __call__(self, *inputs: torch.Tensor) -> Output:
        kernels.require(len(inputs) == len(self.inputs)
                        and all(a.shape == b.shape for a, b in zip(inputs, self.inputs)),
                        "CapturedProgram: inputs of the captured shapes")
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
            self.graph.replay()
            self.replays += 1
            out = _clone(self.output)
            self._done = torch.cuda.Event()
            self._done.record(stream)
        return out
