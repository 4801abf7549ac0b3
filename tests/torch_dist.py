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

import contextlib
import os
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a rank's collectives and the wait for its result: generous, since the
# suite's workers compile psd_tpu beside ranks that run below them (nice 5)
TIMEOUT_S = 300


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


# ---- int8 activation codes -------------------------------------------------------------
# Two fp32 runs that sum in other orders (two implementations, or a site's
# K split over tp ranks) flip an int8 rounding now and then, and the
# quantizations after it amplify one flip to ~1e-2 of an eps
# (tests/test_torch_unet_int8.py). So an int8 run is held to another on
# the other's activation codes, handed over at each quantization.
@contextlib.contextmanager
def recorded_codes(seen: list):
    """Every activation quantization of the port inside the block (`quant.
    quant_rows`, `quant_samples`) appended to `seen` in call order as
    numpy (codes, scales)."""
    from psd_tpu_torch.ops import quant

    rows, samples = quant.quant_rows, quant.quant_samples

    def rec(own):
        def quantize(x, *group):
            q, s = own(x, *group)
            seen.append((q.cpu().numpy(), s.cpu().numpy()))
            return q, s
        return quantize

    quant.quant_rows, quant.quant_samples = rec(rows), rec(samples)
    try:
        yield seen
    finally:
        quant.quant_rows, quant.quant_samples = rows, samples


@contextlib.contextmanager
def handed_codes(seen: list):
    """Each activation quantization of the port inside the block replaced
    by the next record of `seen` (another run's, on the whole rows); at a
    row-parallel site (`quant_rows(x, group)`: this tp rank's columns) the
    rank's columns of it. Yields a count: `differ` of the port's own codes
    differ from the records', of `codes`, in `calls` calls."""
    from psd_tpu_torch.ops import quant

    calls = iter(seen)
    count = {"differ": 0, "codes": 0, "calls": 0}
    rows, samples = quant.quant_rows, quant.quant_samples

    def hand(own):
        def quantize(x, group=None):
            q, s = own(x) if group is None else own(x, group)
            qj, sj = next(calls)
            qj = torch.from_numpy(qj.copy())
            if group is not None:
                k, r = q.shape[-1], dist.get_rank(group)
                qj = qj.reshape(q.shape[:-1] + (-1,))[..., r * k:(r + 1) * k]
            qj = qj.reshape(q.shape).to(q.device)
            count["differ"] += int((q != qj).sum())
            count["codes"] += q.numel()
            count["calls"] += 1
            return qj, torch.from_numpy(sj.copy()).reshape(s.shape).to(s.device)
        return quantize

    quant.quant_rows, quant.quant_samples = hand(rows), hand(samples)
    try:
        yield count
    finally:
        quant.quant_rows, quant.quant_samples = rows, samples


# ---- what the ranks run ---------------------------------------------------------------
def _numpy(tensors, cuts=None):
    """name → whole numpy array, for plain tensors and DTensors alike: one
    `all_gather_object` of every rank's shards (not a collective per
    tensor), each whole tensor then concatenated from the shards of the
    ranks along its sharded mesh dim; then, for the tensors `cuts` names
    (`parallel.mesh.tp_cuts`: name → (dim, halves, cut)), one
    `all_gather_object` over the tp group of every rank's slices, each
    part's slices concatenated in rank order ([h_0 h_1 ; g_0 g_1])."""
    from torch.distributed.tensor import DTensor, Shard

    from psd_tpu_torch.parallel.mesh import local

    mine = {k: local(t.detach()).cpu().numpy().copy() for k, t in tensors.items()}
    sharded = {k: t for k, t in tensors.items() if isinstance(t, DTensor)}
    if sharded:
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, {k: mine[k] for k in sharded})
        for k, t in sharded.items():
            (mesh_dim, dim), = [(i, p.dim) for i, p in enumerate(t.placements)
                                if isinstance(p, Shard)]
            index = list(t.device_mesh.get_coordinate())
            index[mesh_dim] = slice(None)
            ranks = t.device_mesh.mesh[tuple(index)].tolist()
            mine[k] = np.concatenate([everyone[r][k] for r in ranks], axis=dim)
    cut = {k: v for k, v in (cuts or {}).items() if k in mine}
    if cut:
        group = next(iter(cut.values()))[2].group
        slices = [None] * dist.get_world_size(group)
        dist.all_gather_object(slices, {k: mine[k] for k in cut}, group=group)
        for k, (dim, halves, _) in cut.items():
            parts = [np.split(s[k], halves, axis=dim) for s in slices]
            mine[k] = np.concatenate([p[h] for h in range(halves) for p in parts], axis=dim)
    return mine


def _state_arrays(state):
    """Whole params, EMA, AdamW moments and accumulators (gathered on every
    rank) as numpy, name → array."""
    from psd_tpu_torch.parallel.mesh import tp_cuts

    cuts = tp_cuts(state.model.core)
    named = dict(state.model.core.named_parameters())
    opt = state.opt_state
    moments = {n: opt.adamw.state[p] for n, p in named.items() if opt.adamw.state.get(p)}
    return {"params": _numpy(named, cuts), "ema": _numpy(state.ema.params, cuts),
            "exp_avg": _numpy({n: s["exp_avg"] for n, s in moments.items()}, cuts),
            "exp_avg_sq": _numpy({n: s["exp_avg_sq"] for n, s in moments.items()}, cuts),
            "acc": None if opt.acc is None else _numpy(dict(zip(named, opt.acc)), cuts),
            "ema_count": state.ema.count, "count": opt.count}


def tiny_steps(dp: int, fsdp: int, overrides: dict, batches: list, steps: int,
               remat: bool = False, draws=None, tp: int = 1, fault=None):
    """The port's step on `tiny_dadd(seed=0)`, `steps` times, on this rank's
    rows of each global batch (numpy dicts), the draws the generator's or
    the global ones given (one dict a step); with a (dp, fsdp, tp) mesh when
    dp or fsdp is given (None: one process, no group); `fault` a planted
    fault of the tp step (TP_FAULTS). → per step the metrics, the raw
    averaged gradients and the state's arrays (whole), and the initial
    parameters."""
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch, tp_cuts
    from psd_tpu_torch.testing import tiny_dadd
    from psd_tpu_torch.train import create_train_state, make_train_step
    from psd_tpu_torch.train.trainer import shard_train_state

    model = tiny_dadd(for_training=True, seed=0, remat=remat)
    for (section, name), value in overrides.items():
        setattr(getattr(model.cfg, section), name, value)
    state, tx = create_train_state(model, steps_per_epoch=10, seed=0)
    mesh = None
    init = _numpy(dict(model.core.named_parameters()))
    if dp is not None:
        mesh = create_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp), "cpu")
        state = shard_train_state(state, mesh)
    step = make_train_step(model, tx, mesh)
    named = list(dict(model.core.named_parameters()))
    cuts = tp_cuts(model.core)
    seen = []
    apply_ = tx.apply_

    def recording(opt_state, params, grads, groups, applies, scalars=()):
        seen.append(_numpy(dict(zip(named, grads)), cuts))
        return apply_(opt_state, params, grads, groups, applies, scalars)

    tx.apply_ = recording
    metrics, states = [], []
    with TP_FAULTS[fault]() if fault else contextlib.nullcontext():
        for i in range(steps):
            batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[i].items()}
            mine = shard_batch(mesh, batch)
            d = None if draws is None else {k: torch.from_numpy(np.array(v)) for k, v in
                                            draws[i].items()}
            state, m = step(state, mine, draws=d)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(_state_arrays(state))
    return {"metrics": metrics, "grads": seen, "states": states, "init": init,
            "local": {k: tuple(p.shape) for k, p in model.core.named_parameters()
                      if k in cuts}}


@contextlib.contextmanager
def _f_off_the_context():
    """The planted fault: no f on the cross-attention's context tokens (the
    conditioning modules then get a part of their gradient on each tp
    rank). The context is told from the LayerNorm's output by its 12
    tokens (the tiny model's 4 + 4 + 4; its sites hold 16 or more)."""
    from psd_tpu_torch.models import layers

    copy = layers.copy_to_tp
    layers.copy_to_tp = lambda x, group: x if x.shape[1] == 12 else copy(x, group)
    try:
        yield
    finally:
        layers.copy_to_tp = copy


@contextlib.contextmanager
def _g_reducing_backward():
    """The planted fault: g's backward all-reduces too, as
    torch.distributed.nn.functional.all_reduce's does (the residual
    stream's gradient tp times too large)."""
    from psd_tpu_torch.parallel import mesh

    class Both(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return mesh.tp_all_reduce(x.clone(), group)

        @staticmethod
        def backward(ctx, grad):
            return mesh.tp_all_reduce(grad.clone(), ctx.group), None

    from psd_tpu_torch.models import layers

    reduce = layers.reduce_from_tp
    layers.reduce_from_tp = lambda x, group: x if group is None else Both.apply(x, group)
    try:
        yield
    finally:
        layers.reduce_from_tp = reduce


TP_FAULTS = {"f_off_context": _f_off_the_context, "g_reducing_backward": _g_reducing_backward}


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


def tiny_runs(dp: int, fsdp: int, runs: dict, batches: list, remat: bool = False,
              tp: int = 1):
    """`tiny_steps` for each run (name → (overrides, steps), or (overrides,
    steps, fault)) in turn."""
    return {name: tiny_steps(dp, fsdp, spec[0], batches, spec[1], remat, tp=tp,
                             fault=spec[2] if len(spec) > 2 else None)
            for name, spec in runs.items()}


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
    another tp group (a second mesh of the same shape: new tp groups) or
    reloaded; and what runs under tp: the eps in training mode, a training
    model's cut, the train state's, the int8 UNet and its server. → what
    each rank saw."""
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
        "load_core_state_dict": refusal(lambda: model.load_core_state_dict(
            whole.core.state_dict())),
        "load_flax": refusal(lambda: model.load_flax(core_tree={})),
    }
    out["eps_in_scope"] = eps_in(mesh).numpy()

    def whole_eps(m, training=False):
        with torch.no_grad(), (training_mode() if training else contextlib.nullcontext()):
            return m.core.eps(x, steps, cond, 1.0).numpy()

    training = tiny_dadd(for_training=True, seed=0)
    rows = training.core.unet.down_blocks_0_attentions_0.transformer_blocks_0.attn1.to_q.weight
    whole_rows = rows.shape[0]
    training.shard_tp_(mesh)
    state, _ = create_train_state(tiny_dadd(for_training=True, seed=0), steps_per_epoch=10)
    state = shard_train_state(state, mesh)
    key = "unet.down_blocks_0_attentions_0.transformer_blocks_0.attn1.to_q.weight"
    q8, q8_whole = tiny_dadd(seed=0, quant="int8"), tiny_dadd(seed=0, quant="int8")
    q8.shard_tp_(mesh)
    with torch.no_grad(), recorded_codes([]) as codes:
        q8_whole_eps = q8_whole.core.eps(x, steps, cond, 1.0).numpy()
    with tp_scope(mesh), torch.no_grad(), handed_codes(codes) as count:
        q8_eps = q8.core.eps(x, steps, cond, 1.0).numpy()
    assert count["calls"] == len(codes) > 0
    server = serve.GenerationServer(tiny_dadd(seed=0, quant="int8"), max_batch=4, mesh=mesh)
    server.close(timeout=TIMEOUT_S)
    out["runs"] = {
        "eps in training": {"cut": eps_in(mesh, training=True).numpy(),
                            "whole": whole_eps(whole, training=True)},
        "a training model": [rows.shape[0], whole_rows],
        "shard_train_state": {"ddp_ranks": state.loss.process_group.size(),
                              "ema_rows": state.ema.params[key].shape[0],
                              "param_rows": dict(state.model.core.named_parameters())[key]
                              .shape[0]},
        "the int8 UNet": {"cut": q8_eps, "whole": q8_whole_eps},
        "a server of the int8 UNet": "closed" if not server._worker.is_alive() else "alive",
    }
    return out


# the int8 UNet with one 512-channel stage (tests/test_torch_unet_int8.py's
# "wide512"): qdense's int8 branch at every projection of that stage
INT8_GATES = dict(gate_init_anatomy=(0.9, 0.1), gate_init_disease=(0.1, 0.9))
INT8_WIDE = dict(block_out_channels=(32, 512), num_heads=8)


def _wait_for(path: Path, timeout: float = TIMEOUT_S):
    """The pickle at `path`, once the test process has written it."""
    import pickle

    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{path} was never written")
        time.sleep(0.2)
    return pickle.loads(path.read_bytes())


def tp_int8_ranks(dp: int, inputs: dict, records: str) -> dict:
    """The int8 UNet under tp on this group's ranks at (dp, fsdp 1, tp 2)
    (tests/test_torch_tp_int8.py): the wide512 int8 UNet on
    `tiny_dadd(seed=2)`'s weights, quantized whole then cut, its eps inside
    the mesh's tp scope on psd_tpu's activation codes (read from `records`
    once the test process has recorded them; each rank's columns at a
    row-parallel site); at dp 1 also the tiny int8 model's server on the
    mesh against the one-process server run on this rank, on its codes.
    → what each rank saw."""
    from psd_tpu_torch.models.layers import quantize_int8_weights_
    from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_tp_, tp_scope
    from psd_tpu_torch.pipelines import serve
    from psd_tpu_torch.testing import tiny_dadd

    mesh = create_mesh(MeshConfig(dp=dp, tp=2), "cpu")
    src = tiny_dadd(seed=2, **INT8_GATES, **INT8_WIDE)
    unet = UNet2DCondition(tiny_unet_config(attn_mode="split3", num_aoe_tokens=4,
                                            num_image_tokens=4, num_delta_tokens=4,
                                            **INT8_GATES, **INT8_WIDE, quant="int8"))
    unet.load_state_dict(src.core.unet.state_dict())
    quantize_int8_weights_(unet)
    shard_tp_(unet, mesh)
    out = {"to_out_0_cols": unet.mid_block_attentions_0.transformer_blocks_0.attn1.to_out_0
           .weight.shape[1]}
    if dp == 1:
        serve.IDLE_HEADER_S = 0.05
        whole, cut = tiny_dadd(seed=0, quant="int8"), tiny_dadd(seed=0, quant="int8")

        def images(model, mesh_=None):
            s = serve.GenerationServer(model, image_size=32, sampling_steps=4, max_batch=4,
                                       max_wait_s=0.05, mesh=mesh_)
            got = None
            if dist.get_rank() == 0 or mesh_ is None:
                futures = [s.submit(*r) for r in inputs["requests"]]
                got = [f.result(timeout=TIMEOUT_S) for f in futures]
            s.close(timeout=TIMEOUT_S)
            return got

        with recorded_codes([]) as codes:
            out["one_process"] = images(whole)
        with handed_codes(codes) as count:
            out["server"] = images(cut, mesh)
        out["server_own_codes"] = images(cut, mesh)
        out["server_calls"] = (count["calls"], len(codes))
        feats = torch.from_numpy(np.stack([r[0] for r in inputs["requests"][:4]]))
        labels = torch.tensor([r[1] for r in inputs["requests"][:4]])
        cond = cut.prepare_inference_cond(labels, torch.ones(4), feats)
        x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 16, 16, 4))
                              .astype(np.float32))
        out["images"] = cut.decode_latents(cut.sample(cond, x0, 4, 1.0, mesh=mesh),
                                           mesh=mesh).numpy()
    x, t, ctx = (torch.from_numpy(inputs[k]) for k in ("x", "t", "ctx"))
    seen = _wait_for(Path(records))
    with tp_scope(mesh), handed_codes(seen) as count, torch.no_grad():
        out["eps"] = unet(x, t, ctx, 0.5).numpy()
    out["codes"] = dict(count, records=len(seen))
    return out


def tp_checkpoint_ranks(work: str, overrides: dict, batches: list) -> dict:
    """Checkpoints of a tp train state on this group's two ranks
    (tests/test_torch_tp_train_fsdp.py): three one-process steps of
    `tiny_dadd(seed=0)` on each rank alike (with accumulation 2: an
    optimizer step, then a micro-step, so moments and accumulated gradients
    are set), rank 0 writing that state (the one-card checkpoint); the
    stepped state cut onto a (dp 1, tp 2) mesh, its snapshot, and its
    checkpoint; a fresh state on the mesh restoring the one-card
    checkpoint, and (rank 0 alone) a fresh one-card state restoring the tp
    checkpoint, then the infer CLI's reading of its params.pt and ema.pt
    into a serving model. → the one-process state, the snapshot (rank 0),
    the restored states, gathered whole."""
    from psd_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from psd_tpu_torch.testing import tiny_dadd
    from psd_tpu_torch.train import (CheckpointManager, create_train_state, load_weights,
                                     make_train_step)
    from psd_tpu_torch.train.checkpoint import restore_into, snapshot, step_dir
    from psd_tpu_torch.train.trainer import shard_train_state

    work, rank = Path(work), dist.get_rank()

    def fresh():
        model = tiny_dadd(for_training=True, seed=0)
        for (section, name), value in overrides.items():
            setattr(getattr(model.cfg, section), name, value)
        return create_train_state(model, steps_per_epoch=10, seed=0)

    state, tx = fresh()
    step = make_train_step(state.model, tx)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    out = {"one_process": _state_arrays(state)}
    if rank == 0:
        one = CheckpointManager(work / "one")
        one.save(len(batches), state)
        one.wait()
    dist.barrier()
    mesh = create_mesh(MeshConfig(dp=1, tp=2), "cpu")
    state = shard_train_state(state, mesh)
    snap = snapshot(state)
    if snap is not None:
        opt = snap["optimizer.pt"]
        out["snapshot"] = {"params": snap["params.pt"], "ema": snap["ema.pt"],
                           "exp_avg": opt["exp_avg"], "exp_avg_sq": opt["exp_avg_sq"],
                           "acc": opt["acc"]}
        out["snapshot"] = {k: {n: t.numpy() for n, t in v.items()}
                           for k, v in out["snapshot"].items()}
    tp_dir = CheckpointManager(work / "tp")
    tp_dir.save(len(batches), state)
    tp_dir.wait()
    dist.barrier()
    restored, _ = fresh()
    restored = shard_train_state(restored, mesh)
    restore_into(restored, step_dir(work / "one"))
    out["one_on_tp"] = _state_arrays(restored)
    out["step_on_tp"] = (restored.step, restored.opt_state.count, restored.opt_state.mini_step)
    if rank == 0:
        on_one, _ = fresh()
        restore_into(on_one, step_dir(work / "tp"))
        out["tp_on_one"] = _state_arrays(on_one)
        serving = tiny_dadd(seed=None)
        for ema in (False, True):
            serving.load_core_state_dict(load_weights(work / "tp", ema=ema))
        out["served_from_tp"] = True
    return out
