"""In-process generation server: a request queue, micro-batching, padding of
partial batches, and pipelined dispatch.

Counterpart of `psd_tpu/pipelines/serve.py::GenerationServer`. Requests
(CLIP features + target/source labels) are queued, grouped into batches of
exactly `max_batch` (partial batches are padded with copies of the last
request), generated and fulfilled as futures. The turbo levers (`sampler`,
`encoder_stride`, `cache_mode`; psd_tpu's `pipelines/serve.py:58-79`) pass
through to every batch; the VAE's int8 mode is the model's
(`VAEConfig(quant="int8")`).

`fused=True` (default) runs a batch through `DADD.generate`: on the card,
one replay of one captured CUDA graph (sampler loop and decode). `fused=False`
makes two: `DADD.sample`, then `DADD.decode_latents` (psd_tpu's
`serve.py:176-191`). The worker runs in a copy of the context the server was
built in, so `core.mode.eager()` or `disable_kernels(...)` around the
construction hold for every batch it serves.

Pipelining (`pipeline_depth`, default 2): the worker dispatches batch N+1
before it reads batch N back to the host. On a GPU the batch is enqueued (or
replayed) on the server's own CUDA stream and an event marks its end, so the
readback of one batch waits only for that batch; this takes the place of
JAX's async dispatch. Each replay hands back a copy of the graph's output,
which batch N+1's replay does not overwrite. `pipeline_depth=1` is strictly
serialized.

Noise: one `torch.Generator` per batch, seeded from the batch's first
request's seed; co-batched requests get distinct noise, and a request is
reproducible when it leads its batch.
"""

from __future__ import annotations

import contextlib
import contextvars
import queue
import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# base of the per-batch seed (psd_tpu folds the seed into PRNGKey(17))
SEED_BASE = 17 << 32


@dataclass
class GenRequest:
    clip_feats: np.ndarray  # (S, D) single-sample CLIP features
    target_label: float
    source_label: float
    seed: int = 0
    future: Future = field(default_factory=Future)


class GenerationServer:
    def __init__(self, model, image_size: int = 256, sampling_steps: int = 50,
                 steer_scale: float = 1.0, max_batch: int = 8, max_wait_s: float = 0.05,
                 pipeline_depth: int = 2, encoder_stride: int = 1, cache_mode: str = "encoder",
                 sampler: str = "ddim", fused: bool = True):
        self.model = model
        self.image_size = image_size
        self.steps = sampling_steps
        self.steer = steer_scale
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # the turbo levers, passed to every batch's generate
        self.turbo = dict(encoder_stride=encoder_stride, cache_mode=cache_mode, sampler=sampler)
        # one replay a batch (generate), or two (sample, then decode_latents)
        self.fused = fused
        self.device = model.device
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: "queue.Queue[Optional[GenRequest]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=contextvars.copy_context().run,
                                        args=(self._run,), daemon=True)
        self._worker.start()

    # ---- client API -----------------------------------------------------
    def submit(self, clip_feats, target_label, source_label, seed=0) -> Future:
        req = GenRequest(np.asarray(clip_feats, np.float32), float(target_label),
                         float(source_label), int(seed))
        self._q.put(req)
        return req.future

    def close(self, timeout: float = 600.0):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=timeout)

    # ---- worker ----------------------------------------------------------
    def _collect_batch(self, block: bool = True):
        try:
            first = self._q.get() if block else self._q.get(timeout=self.max_wait_s)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                req = self._q.get(timeout=self.max_wait_s)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # keep the sentinel for shutdown
                break
            batch.append(req)
        return batch

    def _run(self):
        inflight: deque = deque()  # (requests, images on device, done event)
        while True:
            batch = self._collect_batch(block=not inflight)
            if batch:
                try:
                    inflight.append((batch, *self._dispatch(batch)))
                except Exception as e:  # a failed batch fails its futures
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(e)
            if inflight and (len(inflight) >= self.pipeline_depth or not batch):
                reqs, imgs, done = inflight.popleft()
                try:
                    self._fulfill(reqs, imgs, done)
                except Exception as e:
                    for req in reqs:
                        if not req.future.done():
                            req.future.set_exception(e)
            if self._stop.is_set() and not inflight and self._q.empty():
                return

    def _dispatch(self, batch):
        """Pad the batch to max_batch and enqueue (or replay) generation; no
        host sync."""
        n, B = len(batch), self.max_batch
        feats = np.stack([r.clip_feats for r in batch])
        if n < B:
            feats = np.concatenate([feats, np.repeat(feats[-1:], B - n, 0)])
        targets = np.asarray([r.target_label for r in batch] + [0.0] * (B - n), np.float32)
        sources = np.asarray([r.source_label for r in batch] + [0.0] * (B - n), np.float32)
        gen = torch.Generator(device=self.device).manual_seed(SEED_BASE + batch[0].seed)
        stream = self._stream
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            cond = self.model.prepare_inference_cond(targets, sources, feats)
            if self.fused:
                imgs = self.model.generate(cond, generator=gen, image_size=self.image_size,
                                           sampling_steps=self.steps, steer_scale=self.steer,
                                           shared_noise=False, **self.turbo)
            else:
                x0 = self.model.initial_noise(B, self.image_size, gen, shared_noise=False)
                lat = self.model.sample(cond, x0, self.steps, self.steer, **self.turbo)
                imgs = self.model.decode_latents(lat)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        return imgs, done

    def _fulfill(self, reqs, imgs, done):
        """Host readback and future fulfillment (what pipelining overlaps)."""
        if done is not None:
            done.synchronize()
        host = imgs.cpu().numpy()
        for req, img in zip(reqs, host[: len(reqs)]):
            req.future.set_result(img)

