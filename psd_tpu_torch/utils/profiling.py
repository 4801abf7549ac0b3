"""Phase timers and a profiler trace for the CLIs.

Counterpart of `psd_tpu/utils/profiling.py`, on `torch.profiler` in place of
`jax.profiler`:

    timer = PhaseTimer(device)
    with trace_if(out_dir / "trace", enabled=args.profile):
        with timer.phase("generate"):
            ...
    print(timer.report())

A phase on the card ends with `torch.cuda.synchronize` (unless the timer
is built with `sync=False`), so its wall time holds the device work it
enqueued. Without the sync a phase's time is the host's alone, and the
device work it enqueued lands in whichever later phase waits for it. The trace is a Chrome trace
(`trace.json`, readable in Perfetto or chrome://tracing), of the host and,
on the card, of the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace_if(log_dir, enabled: bool = True) -> Iterator[None]:
    """Profile the block into `<log_dir>/trace.json` when enabled."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """A named range on the trace's timelines."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Wall-clock seconds by phase; on a CUDA `device` each phase ends with a
    synchronize of that device when `sync`."""

    def __init__(self, device="cpu", sync: bool = True):
        self.device = torch.device(device)
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.laps: Dict[str, List[float]] = defaultdict(list)  # each call's seconds

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with annotate(name):
            yield
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        lap = time.perf_counter() - t0
        self.totals[name] += lap
        self.counts[name] += 1
        self.laps[name].append(lap)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n, tot = self.counts[name], self.totals[name]
            lines.append(f"{name}: {tot:.3f}s total, {tot / n * 1e3:.1f}ms avg ×{n}")
        return "\n".join(lines)
