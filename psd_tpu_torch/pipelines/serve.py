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

Across ranks (`mesh`, psd_tpu's `serve.py:57,87,187`): the server is built
on every rank of torchrun's group with the same model and arguments, and
`fused` is off (`DADD.sample(mesh=)`, then `decode_latents(mesh=)`: each
rank replays its own programs on its rows, and the gathers run between
them). Rank 0 owns the queue, the batching, the padding and the futures;
for each batch it broadcasts a fixed-shape header (rows used, the leading
request's seed, stop, the features' shape), then the padded features and
labels, and every rank builds the conditioning, draws the batch's global
noise from the batch's generator and takes its rows of it. The other
ranks' workers follow rank 0's headers in the same collective order; there
`submit` raises and `close` waits for rank 0's stop, which rank 0's `close`
sends. An idle rank 0 sends an idle header every `IDLE_HEADER_S`, so the
waiting ranks' broadcast stays inside the group's timeout. No fallback: a
failed batch on rank 0 (a collective, a capture, a rank that raised and
left a gather waiting until its timeout) fails its futures and every later
request, and the server stops; a rank ≥ 1 whose worker failed raises the
error from `close`. On a mesh with a tp axis the rows follow (dp, fsdp), the
header and stop still go over the whole world, and the model's UNet is cut
over tp when the server is built (`DADD.shard_tp_`; an int8 or training
model raises there); each batch's sample then runs op by op.
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

from ..parallel.mesh import TIMEOUT_S, batch_rows, broadcast

# base of the per-batch seed (psd_tpu folds the seed into PRNGKey(17))
SEED_BASE = 17 << 32
# across ranks: rank 0's header, and how long an idle rank 0 waits for a
# request before it tells the other ranks it is idle
HEADER = ("rows", "seed", "stop", "feat_tokens", "feat_dim")
IDLE_HEADER_S = TIMEOUT_S / 4


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
                 sampler: str = "ddim", fused: bool = True, mesh=None):
        self.model = model
        self.image_size = image_size
        self.steps = sampling_steps
        self.steer = steer_scale
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # the turbo levers, passed to every batch's generate
        self.turbo = dict(encoder_stride=encoder_stride, cache_mode=cache_mode, sampler=sampler)
        self.mesh = mesh
        if mesh is not None:
            batch_rows(mesh, max_batch)  # raises where the ranks do not split it
            model.shard_tp_(mesh)
        # one replay a batch (generate), or two (sample, then decode_latents)
        self.fused = fused and mesh is None
        self.rank = 0 if mesh is None else mesh.get_rank()
        self.device = model.device
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: "queue.Queue[Optional[GenRequest]]" = queue.Queue()
        self._stop = threading.Event()
        # why the worker stopped serving (a failed batch under a mesh)
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=contextvars.copy_context().run,
                                        args=(self._run if self.rank == 0 else self._follow,),
                                        daemon=True)
        self._worker.start()

    # ---- client API -----------------------------------------------------
    def submit(self, clip_feats, target_label, source_label, seed=0) -> Future:
        if self.rank != 0:
            raise RuntimeError(f"submit on rank {self.rank}: rank 0 owns the queue; the "
                               "other ranks' servers follow its batches")
        if self._error is not None:
            raise RuntimeError("the server stopped after a failed batch") from self._error
        req = GenRequest(np.asarray(clip_feats, np.float32), float(target_label),
                         float(source_label), int(seed))
        self._q.put(req)
        return req.future

    def close(self, timeout: float = 600.0):
        """Rank 0 (or no mesh): serve what is queued, then stop (and stop
        the other ranks). Another rank: wait for rank 0's stop; raise the
        error its worker failed with."""
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=timeout)
        if self.rank != 0 and self._error is not None:
            raise RuntimeError(f"rank {self.rank}'s server failed") from self._error

    # ---- worker ----------------------------------------------------------
    def _collect_batch(self, block: bool = True):
        try:
            if not block:
                first = self._q.get(timeout=self.max_wait_s)
            elif self.mesh is None:
                first = self._q.get()
            else:
                first = self._q.get(timeout=IDLE_HEADER_S)
        except queue.Empty:
            if block:
                self._header()  # idle: the other ranks wait on the next header
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
                    self._fail(batch, e)
                    if self.mesh is not None:
                        return self._abandon(inflight, e)
            if inflight and (len(inflight) >= self.pipeline_depth or not batch):
                reqs, imgs, done = inflight.popleft()
                try:
                    self._fulfill(reqs, imgs, done)
                except Exception as e:
                    self._fail(reqs, e)
                    if self.mesh is not None:
                        return self._abandon(inflight, e)
            if self._stop.is_set() and not inflight and self._q.empty():
                if self.mesh is not None:
                    self._header(stop=True)
                return

    @staticmethod
    def _fail(reqs, e):
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(e)

    def _abandon(self, inflight, e):
        """Under a mesh a failed batch ends the serving: a rank may have left
        the order of collectives, and no batch goes on with fewer ranks.
        Every request in flight or queued fails with `e`; the other ranks
        get the stop where the group still carries it."""
        self._error = e
        for reqs, *_ in inflight:
            self._fail(reqs, e)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._fail([req], e)
        self._header(stop=True)

    def _header(self, rows: int = 0, seed: int = 0, stop: bool = False,
                feats_shape=(0, 0)) -> dict:
        """Rank 0's header of the next step of every rank's worker, the same
        on every rank after this call (rows 0 without stop: idle)."""
        h = torch.tensor([rows, seed, int(stop), *feats_shape], dtype=torch.int64,
                         device=self.device)
        return dict(zip(HEADER, broadcast(self.mesh, h).tolist()))

    def _follow(self):
        """A rank ≥ 1's worker: each batch rank 0 announces, through the same
        programs and collectives, until rank 0's stop."""
        try:
            while True:
                h = self._header()
                if h["stop"]:
                    return
                if not h["rows"]:
                    continue
                feats = torch.empty((self.max_batch, h["feat_tokens"], h["feat_dim"]),
                                    dtype=torch.float32, device=self.device)
                labels = torch.empty((2, self.max_batch), dtype=torch.float32, device=self.device)
                self._generate(broadcast(self.mesh, feats), broadcast(self.mesh, labels),
                               h["seed"])
        except Exception as e:
            self._error = e
            raise

    def _dispatch(self, batch):
        """Pad the batch to max_batch and enqueue (or replay) generation; no
        host sync. Under a mesh, rank 0 first hands the batch to the other
        ranks."""
        n, B = len(batch), self.max_batch
        feats = np.stack([r.clip_feats for r in batch])
        if n < B:
            feats = np.concatenate([feats, np.repeat(feats[-1:], B - n, 0)])
        labels = np.asarray([[r.target_label for r in batch] + [0.0] * (B - n),
                             [r.source_label for r in batch] + [0.0] * (B - n)], np.float32)
        feats = torch.from_numpy(feats).to(self.device)
        labels = torch.from_numpy(labels).to(self.device)
        if self.mesh is not None:
            self._header(n, batch[0].seed, feats_shape=feats.shape[1:])
            broadcast(self.mesh, feats)
            broadcast(self.mesh, labels)
        return self._generate(feats, labels, batch[0].seed)

    def _generate(self, feats, labels, seed: int):
        """One padded batch (feats (B, S, D), labels (2, B): target, source)
        through the model on the server's stream → (images, done event)."""
        B = self.max_batch
        gen = torch.Generator(device=self.device).manual_seed(SEED_BASE + seed)
        stream = self._stream
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            cond = self.model.prepare_inference_cond(labels[0], labels[1], feats)
            if self.fused:
                imgs = self.model.generate(cond, generator=gen, image_size=self.image_size,
                                           sampling_steps=self.steps, steer_scale=self.steer,
                                           shared_noise=False, **self.turbo)
            else:
                # the batch's global noise on every rank; sample takes a rank's rows
                x0 = self.model.initial_noise(B, self.image_size, gen, shared_noise=False)
                lat = self.model.sample(cond, x0, self.steps, self.steer, mesh=self.mesh,
                                        **self.turbo)
                imgs = self.model.decode_latents(lat, mesh=self.mesh)
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
