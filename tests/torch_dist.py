"""Ranks of torch.distributed on the CPU for the port's parallel tests.

`run_ranks(fn, world, tmp_path, *args)` spawns `world` processes that join
one gloo group through a `file://` store under `tmp_path` (never a TCP
port: the suite runs several workers at once), each with two threads and
a timeout of its own, so a hung collective fails the test instead of
hanging the run (`Ranks` starts them and leaves the caller free until
`join`). Each rank calls `fn(*args)` and hands back what it returns; a
rank that raises fails the test with its traceback. `fn` lives in an
importable module (spawned processes import it), and the functions the
tests run live here: the port imports nothing from `tests/`.
"""

from __future__ import annotations

import os
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _entry(fn, rank, world, store, timeout, out, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    os.nice(5)  # below the caller, which may compile beside its ranks
    torch.set_num_threads(2)
    from threadpoolctl import threadpool_limits

    try:
        with threadpool_limits(2):
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world, timeout=timedelta(seconds=timeout))
            try:
                out.put((rank, "ok", fn(*args)))
            finally:
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


class Ranks:
    """`world` spawned gloo ranks running fn(*args); `join` → their results."""

    def __init__(self, fn, world: int, tmp_path: Path, *args, timeout: float = TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.world, self.timeout, self.out = world, timeout, ctx.Queue()
        store = Path(tmp_path) / f"store_{fn.__name__}_{os.urandom(4).hex()}"
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, store, timeout, self.out, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self) -> list:
        results, errors = {}, []
        try:
            for _ in range(self.world):
                rank, status, value = self.out.get(timeout=self.timeout + 60)
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        if errors:
            raise AssertionError("\n".join(errors))
        return [results[r] for r in range(self.world)]


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout: float = TIMEOUT_S) -> list:
    """fn(*args) on each of `world` gloo ranks → their results, by rank."""
    return Ranks(fn, world, tmp_path, *args, timeout=timeout).join()


# ---- what the ranks run ---------------------------------------------------------------
def _numpy(tensors):
    """name → whole numpy array, for plain tensors and DTensors alike: one
    `all_gather_object` of every rank's shards (not a collective per
    tensor), each whole tensor then concatenated from the shards of the
    ranks along its sharded mesh dim."""
    from torch.distributed.tensor import DTensor, Shard

    from psd_tpu_torch.parallel.mesh import local

    mine = {k: local(t.detach()).cpu().numpy().copy() for k, t in tensors.items()}
    sharded = {k: t for k, t in tensors.items() if isinstance(t, DTensor)}
    if not sharded:
        return mine
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {k: mine[k] for k in sharded})
    for k, t in sharded.items():
        (mesh_dim, dim), = [(i, p.dim) for i, p in enumerate(t.placements) if isinstance(p, Shard)]
        index = list(t.device_mesh.get_coordinate())
        index[mesh_dim] = slice(None)
        ranks = t.device_mesh.mesh[tuple(index)].tolist()
        mine[k] = np.concatenate([everyone[r][k] for r in ranks], axis=dim)
    return mine


def _state_arrays(state):
    """Whole params, EMA, AdamW moments and accumulators (gathered on every
    rank) as numpy, name → array."""
    named = dict(state.model.core.named_parameters())
    opt = state.opt_state
    moments = {n: opt.adamw.state[p] for n, p in named.items() if opt.adamw.state.get(p)}
    return {"params": _numpy(named), "ema": _numpy(state.ema.params),
            "exp_avg": _numpy({n: s["exp_avg"] for n, s in moments.items()}),
            "exp_avg_sq": _numpy({n: s["exp_avg_sq"] for n, s in moments.items()}),
            "acc": None if opt.acc is None else _numpy(dict(zip(named, opt.acc))),
            "ema_count": state.ema.count, "count": opt.count}


def tiny_steps(dp: int, fsdp: int, overrides: dict, batches: list, steps: int,
               remat: bool = False, draws=None):
    """The port's step on `tiny_dadd(seed=0)`, `steps` times, on this rank's
    rows of each global batch (numpy dicts), the draws the generator's or
    the global ones given (one dict a step); with a mesh when dp or fsdp
    is given (None: one process, no group). → per step the metrics, the
    raw averaged gradients and the state's arrays (whole), and the initial
    parameters."""
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch
    from psd_tpu_torch.testing import tiny_dadd
    from psd_tpu_torch.train import create_train_state, make_train_step
    from psd_tpu_torch.train.trainer import shard_train_state

    model = tiny_dadd(for_training=True, seed=0, remat=remat)
    for (section, name), value in overrides.items():
        setattr(getattr(model.cfg, section), name, value)
    state, tx = create_train_state(model, steps_per_epoch=10, seed=0)
    mesh = None
    if dp is not None:
        mesh = create_mesh(MeshConfig(dp=dp, fsdp=fsdp), "cpu")
        state = shard_train_state(state, mesh)
    step = make_train_step(model, tx, mesh)
    named = list(dict(model.core.named_parameters()))
    seen = []
    update = tx.update

    def recording(opt_state, params, grads, group=None):
        seen.append(_numpy(dict(zip(named, grads))))
        return update(opt_state, params, grads, group)

    tx.update = recording
    metrics, states = [], []
    init = _numpy(dict(model.core.named_parameters()))
    for i in range(steps):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[i].items()}
        mine = shard_batch(mesh, batch)
        d = None if draws is None else {k: torch.from_numpy(np.array(v)) for k, v in
                                        draws[i].items()}
        state, m = step(state, mine, draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_state_arrays(state))
    return {"metrics": metrics, "grads": seen, "states": states, "init": init}


def shard_round_trip(dp: int, fsdp: int) -> list:
    """`full` and `local_part` on this rank against DTensor's own sharding,
    over even and uneven shapes and every dim: → what disagreed."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, full, local_part

    mesh = create_mesh(MeshConfig(dp=dp, fsdp=fsdp), "cpu")
    bad = []
    for shape, dim in [((5, 3), 0), ((7,), 0), ((3, 8), 1), ((1, 4), 0), ((6, 4, 3), 2)]:
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        dt = distribute_tensor(x, mesh, [Replicate(), Shard(dim)])
        part = local_part(x, dt)
        if not torch.equal(part.to_local(), dt.to_local()):
            bad.append(("local_part", shape, dim))
        if not (torch.equal(full(dt), x) and torch.equal(full(part), x)):
            bad.append(("full", shape, dim))
    return bad


def steps_and_round_trip(dp: int, fsdp: int, *args):
    """`tiny_steps`, then `shard_round_trip`, in one group of ranks."""
    return tiny_steps(dp, fsdp, *args), shard_round_trip(dp, fsdp)


def tiny_runs(dp: int, fsdp: int, runs: dict, batches: list, remat: bool = False):
    """`tiny_steps` for each run (name → (overrides, steps)) in turn."""
    return {name: tiny_steps(dp, fsdp, over, batches, steps, remat)
            for name, (over, steps) in runs.items()}


def cli_main(argv):
    """The train CLI's `main` on this rank → its final step and whole state."""
    from psd_tpu_torch.pipelines import train

    r = train.main(argv)
    return {"step": r["state"].step, **_state_arrays(r["state"])}


SERVE_TURBO = {"exact": {}, "turbo": dict(sampler="dpm", encoder_stride=2, cache_mode="deep")}


def serve_ranks(inputs: dict) -> dict:
    """The port's sampling and serving across this group's ranks on
    `tiny_dadd(seed=0)`, 4 steps, steer 1.0 (tests/test_torch_serve_ranks.py):
    `sample(mesh=)` + `decode_latents(mesh=)` at (dp 2, fsdp 1) and at
    (dp 1, fsdp 2) with CFG, DDIM with eta 0.5 at (2, 1); the refusals of a
    batch the ranks do not split; a `GenerationServer(mesh=)` for each of
    SERVE_TURBO (rank 0 submits `inputs["requests"]`, rank 1 tries to),
    with idle headers before the requests; then a batch that fails on rank
    0 before its header. → what each rank saw, as numpy."""
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from psd_tpu_torch.pipelines import serve
    from psd_tpu_torch.testing import tiny_dadd

    serve.IDLE_HEADER_S = 0.05
    rank = dist.get_rank()
    model = tiny_dadd(seed=0)
    dp2 = create_mesh(MeshConfig(dp=2, fsdp=1), "cpu")
    fsdp2 = create_mesh(MeshConfig(dp=1, fsdp=2), "cpu")
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    cond = model.prepare_inference_cond(t["tgt"], t["src"], t["feats"])
    uncond = model.prepare_inference_cond(t["tgt"], t["src"], t["feats"], zero_aoe=True,
                                          zero_image=True)
    out = {}

    def images(mesh, **kw):
        lat = model.sample(cond, t["x0"], 4, 1.0, mesh=mesh, **kw)
        return model.decode_latents(lat, mesh=mesh).numpy()

    out["dp2"] = images(dp2)
    out["fsdp2_cfg"] = images(fsdp2, cond_uncond=uncond, guidance_scale=2.5)
    out["eta"] = images(dp2, eta=0.5, eta_noise=t["eta_noise"])

    def refusal(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    out["odd_sample"] = refusal(lambda: model.sample(cond[:3], t["x0"][:3], 4, 1.0, mesh=dp2))
    out["odd_decode"] = refusal(lambda: model.decode_latents(t["x0"][:3], mesh=dp2))
    out["odd_server"] = refusal(lambda: serve.GenerationServer(model, max_batch=3, mesh=dp2))

    def server(**kw):
        return serve.GenerationServer(model, image_size=32, sampling_steps=4, max_batch=4,
                                      max_wait_s=0.05, mesh=dp2, **kw)

    for name, turbo in SERVE_TURBO.items():
        s = server(**turbo)
        assert not s.fused
        if rank == 0:
            time.sleep(0.3)  # rank 0 idle: idle headers reach rank 1
            futures = [s.submit(*r) for r in inputs["requests"]]
            out[name] = [f.result(timeout=TIMEOUT_S) for f in futures]
        else:
            try:
                s.submit(*inputs["requests"][0])
            except RuntimeError as e:
                out["submit"] = str(e)
        t0 = time.perf_counter()
        s.close(timeout=TIMEOUT_S)
        out[f"{name}_close_s"] = time.perf_counter() - t0
        out[f"{name}_alive"] = s._worker.is_alive()

    # a batch that fails on rank 0 before its header: requests of two shapes
    s = server()
    if rank == 0:
        feats = inputs["requests"][0][0]
        futures = [s.submit(feats, 1.0, 0.0), s.submit(feats[:5], 2.0, 0.0)]
        out["failed"] = [type(f.exception(timeout=TIMEOUT_S)).__name__ for f in futures]
        s._worker.join(timeout=TIMEOUT_S)
        try:
            s.submit(feats, 1.0, 0.0)
        except RuntimeError as e:
            out["after_failure"] = str(e)
    s.close(timeout=TIMEOUT_S)
    out["failed_alive"] = s._worker.is_alive()
    return out


TINY_TOME_BLOCK = dict(tome_ratio=0.5, tome_min_tokens=256, tome_mode="block")


def tp_ranks(inputs: dict, dp: int) -> dict:
    """The port's serving on this group's ranks at (dp, fsdp 1, tp 2) on
    `tiny_dadd(seed=0)`, 4 steps, steer 1.0 (tests/test_torch_tp.py):
    `sample(mesh=)` + `decode_latents(mesh=)`; at dp 1 also ToMe in block
    mode and a `GenerationServer(mesh=)` for each of SERVE_TURBO (rank 0
    submits `inputs["requests"]`); at dp 2 the cut model's eps inside its
    tp scope and what raises under tp: the cut UNet without its mesh or over
    another tp group (a second mesh of the same shape: new tp groups),
    reloaded, in training, a training model, the train state, the int8
    UNet. → what each rank saw."""
    from psd_tpu_torch.core.mode import training_mode
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, tp_scope
    from psd_tpu_torch.pipelines import serve
    from psd_tpu_torch.testing import tiny_dadd
    from psd_tpu_torch.train import create_train_state
    from psd_tpu_torch.train.trainer import shard_train_state

    serve.IDLE_HEADER_S = 0.05
    rank = dist.get_rank()
    mesh = create_mesh(MeshConfig(dp=dp, tp=2), "cpu")
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}

    def images(model):
        cond = model.prepare_inference_cond(t["tgt"], t["src"], t["feats"])
        lat = model.sample(cond, t["x0"], 4, 1.0, mesh=mesh)
        return model.decode_latents(lat, mesh=mesh).numpy()

    model = tiny_dadd(seed=0)
    out = {"images": images(model), "heads": model.core.unet.down_blocks_0_attentions_0
           .transformer_blocks_0.attn1.to_q.weight.shape[0]}
    if dp == 1:
        out["tome"] = images(tiny_dadd(seed=0, **TINY_TOME_BLOCK))
        out["servers"] = {}
        for name, turbo in SERVE_TURBO.items():
            s = serve.GenerationServer(model, image_size=32, sampling_steps=4, max_batch=4,
                                       max_wait_s=0.05, mesh=mesh, **turbo)
            if rank == 0:
                futures = [s.submit(*r) for r in inputs["requests"]]
                out["servers"][name] = [f.result(timeout=TIMEOUT_S) for f in futures]
            s.close(timeout=TIMEOUT_S)
        return out

    def refusal(fn):
        try:
            fn()
        except (RuntimeError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    cond = model.prepare_inference_cond(t["tgt"], t["src"], t["feats"])
    x = t["x0"]
    steps = torch.full((x.shape[0],), 500)
    other = create_mesh(MeshConfig(dp=dp, tp=2), "cpu")
    whole = tiny_dadd(seed=0)

    def eps_in(scope_mesh, training=False):
        with tp_scope(scope_mesh), torch.no_grad():
            if training:
                with training_mode():
                    return model.core.eps(x, steps, cond, 1.0)
            return model.core.eps(x, steps, cond, 1.0)

    out["other_group"] = other.get_group("tp") is not mesh.get_group("tp")
    out["raises"] = {
        "sample without a mesh": refusal(lambda: model.sample(cond, x, 4, 1.0)),
        "generate": refusal(lambda: model.generate(cond, x0=x, sampling_steps=4)),
        "sample over another tp group": refusal(lambda: model.sample(cond, x, 4, 1.0,
                                                                     mesh=other)),
        "eps without a mesh": refusal(lambda: eps_in(None)),
        "eps over another tp group": refusal(lambda: eps_in(other)),
        "eps in training": refusal(lambda: eps_in(mesh, training=True)),
        "load_core_state_dict": refusal(lambda: model.load_core_state_dict(
            whole.core.state_dict())),
        "load_flax": refusal(lambda: model.load_flax(core_tree={})),
        "a training model": refusal(lambda: tiny_dadd(for_training=True).shard_tp_(mesh)),
        "shard_train_state": refusal(lambda: shard_train_state(
            create_train_state(tiny_dadd(for_training=True), steps_per_epoch=10)[0], mesh)),
        "the int8 UNet": refusal(lambda: tiny_dadd(seed=0, quant="int8").shard_tp_(mesh)),
        "a server of the int8 UNet": refusal(lambda: serve.GenerationServer(
            tiny_dadd(seed=0, quant="int8"), max_batch=4, mesh=mesh)),
    }
    out["eps_in_scope"] = eps_in(mesh).numpy()
    return out


def tp_train_state_refusal() -> str:
    """`shard_train_state` on a (dp 1, tp 2) mesh of this group's ranks →
    its error."""
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from psd_tpu_torch.testing import tiny_dadd
    from psd_tpu_torch.train import create_train_state
    from psd_tpu_torch.train.trainer import shard_train_state

    mesh = create_mesh(MeshConfig(dp=1, tp=2), "cpu")
    state, _ = create_train_state(tiny_dadd(for_training=True, seed=0), steps_per_epoch=10)
    try:
        shard_train_state(state, mesh)
    except NotImplementedError as e:
        return str(e)
    return "no error"
