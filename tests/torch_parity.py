"""One psd_tpu train step and one port train step from the same parameters,
batch and random draws; shared by the port's train-step parity tests.

The JAX state is built from the port's seeded parameters (bridged back with
`to_flax_tree` into the layout `jax.eval_shape` gives), so no JAX init is
compiled. The JAX step is `psd_tpu.train.make_train_step`, jitted; its
gradients are recorded on the way into the optimizer with
`jax.debug.callback`, which leaves the step's math unchanged. The port gets
JAX's draws: noise, t, the drop mask and the noise-offset and
input-perturbation draws recomputed from `jax.random.split(fold_in(key,
step), 6)` as `psd_tpu/diffusion/dadd.py:366-385` draws them, and the
embedder noise (drawn through flax's `make_rng`, which torch cannot redraw)
recorded by running the same `prepare_conditioning` call eagerly with
`jax.random.normal` wrapped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psd_tpu.train import build_optimizer as jax_build_optimizer
from psd_tpu.train import ema_init as jax_ema_init
from psd_tpu.train import make_train_step as jax_make_train_step
from psd_tpu.train.trainer import TrainState as JaxTrainState
from psd_tpu_torch.convert.from_jax import to_flax_tree
from psd_tpu_torch.core.mode import training_mode
from psd_tpu_torch.train import create_train_state, make_train_step

# the train-step settings both sides take: the EMA updates at step 0 (its
# first update copies), image-CFG dropout and the optional draws on, and an
# LR large enough that the step is visible (no warmup: lr(0) = base LR)
OVERRIDES = {
    ("training", "update_starting_at_step"): 0,
    ("training", "update_every_n_steps"): 1,
    ("training", "noise_offset"): 0.05,
    ("training", "input_perturbation"): 0.1,
    ("model", "cfg_drop_prob"): 0.5,
    ("optimizer", "lr"): 1e-3,
    ("scheduler", "warmup_epochs"): 0,
}


def configure(*cfgs):
    for cfg in cfgs:
        for (section, name), value in OVERRIDES.items():
            setattr(getattr(cfg, section), name, value)


def jax_draws(model, key, batch, step: int = 0):
    """The draws of psd_tpu's train_loss at `step`, as numpy arrays."""
    tcfg = model.cfg.training
    latents = batch["latents"]
    B = latents.shape[0]
    r_noise, r_t, r_drop, r_embed, r_offset, r_perturb = jax.random.split(
        jax.random.fold_in(key, step), 6)
    draws = {
        "noise": jax.random.normal(r_noise, latents.shape, jnp.float32),
        "offset_noise": jax.random.normal(r_offset, (B, 1, 1, latents.shape[-1]), jnp.float32),
        "t": jax.random.randint(r_t, (B,), 0, model.cfg.diffusion.num_train_timesteps),
        "perturb_noise": jax.random.normal(r_perturb, latents.shape, jnp.float32),
        "drop_mask": jax.random.uniform(r_drop, (B,)) < model.cfg.model.cfg_drop_prob,
    }
    assert tcfg.noise_offset > 0 and tcfg.input_perturbation > 0
    return {k: np.asarray(v) for k, v in draws.items()}, r_embed


def record_aoe_noise(model, params, batch, drop_mask, r_embed, jit: bool = False):
    """The (target, source) embedder noise flax draws in train_loss; with
    `jit` the call is compiled once instead of run op by op (the same
    numbers, in a fifth of the time for one call)."""
    seen = []
    normal = jax.random.normal

    def recording(key, shape=(), dtype=jnp.float32):
        out = normal(key, shape, dtype)
        # flax traces some calls (jit, eval_shape): record what executes
        jax.debug.callback(lambda x: seen.append((tuple(shape), np.asarray(x))), out)
        return out

    def apply(p, labels, clip_feats, mask, key):
        return model.core.apply(p, labels, clip_feats, None, True, False, 1.0, mask,
                                method=model.core.prepare_conditioning, rngs={"noise": key})

    jax.random.normal = recording
    try:
        out = (jax.jit(apply) if jit else apply)(
            params, jnp.asarray(batch["labels"]), jnp.asarray(batch["clip_feats"]),
            jnp.asarray(drop_mask), r_embed)
        jax.block_until_ready(out)
        jax.effects_barrier()
    finally:
        jax.random.normal = normal
    D = model.core_cfg.embedding_dim
    noise = [a for s, a in seen if s == (batch["labels"].shape[0], D)]
    assert len(noise) == 2, [s for s, _ in seen]
    return np.stack(noise)


def step_pair(jax_model, port, batch, key=jax.random.PRNGKey(3)):
    """Run one step on each side. Returns a dict of numpy results:
    metrics, grads, params and ema (flax layout) for "jax" and "port"."""
    like = jax.eval_shape(lambda k: jax_model.init_core(k, 32), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": to_flax_tree(dict(port.core.named_parameters()), like)})

    tx = jax_build_optimizer(jax_model.cfg, steps_per_epoch=10)
    seen_grads = []

    def update(grads, opt_state, p=None):
        jax.debug.callback(lambda g: seen_grads.append(g), grads)
        return tx.update(grads, opt_state, p)

    tx_rec = optax.GradientTransformation(tx.init, update)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params["params"]),
                          ema=jax_ema_init(params["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new, jmetrics = jax.jit(jax_make_train_step(jax_model, tx_rec))(state, jbatch, key)
    jax.block_until_ready(new)
    assert len(seen_grads) == 1

    draws, r_embed = jax_draws(jax_model, key, batch)
    draws["aoe_noise"] = record_aoe_noise(jax_model, params, batch, draws["drop_mask"], r_embed)
    tdraws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the port's raw gradients (the step clips them in place)
    named = dict(port.core.named_parameters())
    with training_mode():
        loss, _ = port.train_loss(tbatch, draws=tdraws)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
    grads = {k: torch.zeros_like(named[k]) if g is None else g for k, g in grads.items()}

    tstate, tx_p = create_train_state(port, steps_per_epoch=10)
    tstate, pmetrics = make_train_step(port, tx_p)(tstate, tbatch, draws=tdraws)

    return {
        "jax": {"metrics": {k: float(v) for k, v in jmetrics.items()},
                "grads": jax.device_get(seen_grads[0]),
                "params": jax.device_get(new.params["params"]),
                "ema": jax.device_get(new.ema.params), "ema_count": int(new.ema.count),
                "step": int(new.step)},
        "port": {"metrics": {k: float(v) for k, v in pmetrics.items()},
                 "grads": to_flax_tree(grads, like),
                 "params": to_flax_tree(named, like),
                 "ema": to_flax_tree(tstate.ema.params, like), "ema_count": tstate.ema.count,
                 "step": tstate.step},
        "lr": jax_model.cfg.optimizer.lr,
    }


def jax_sharded_step(jm, port, batch, key, mesh_cfg):
    """One step of psd_tpu's compile_train_step on `create_mesh(mesh_cfg)`
    of conftest's virtual devices, its state placed by `shard_train_state`
    (tp-cut transformer kernels first, then fsdp); its gradients recorded
    on the way into the optimizer, as `step_pair` does. → its results (as
    `step_pair`'s "jax"), and the tree layout."""
    from psd_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from psd_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from psd_tpu.train.trainer import compile_train_step, shard_train_state

    like = jax.eval_shape(lambda k: jm.init_core(k, 32), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": to_flax_tree(dict(port.core.named_parameters()), like)})
    tx = jax_build_optimizer(jm.cfg, steps_per_epoch=10)
    seen = []

    def update(grads, opt_state, p=None):
        jax.debug.callback(lambda g: seen.append(g), grads)
        return tx.update(grads, opt_state, p)

    tx_rec = optax.GradientTransformation(tx.init, update)
    mesh = jax_create_mesh(mesh_cfg)
    state = shard_train_state(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params["params"]), ema=jax_ema_init(params["params"])),
        mesh)
    new, metrics = compile_train_step(jm, tx_rec, mesh)(
        state, jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}), key)
    jax.block_until_ready(new)
    assert len(seen) == 1
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.device_get(seen[0]), "params": jax.device_get(new.params["params"]),
            "ema": jax.device_get(new.ema.params), "ema_count": int(new.ema.count),
            "step": int(new.step)}, like


def close_leaves(got, want, what, rel=1e-5):
    """Each leaf (name → array) within rel of each value plus rel of the
    largest over all leaves."""
    floor = rel * max(np.abs(v).max() for v in want.values())
    for name, w in want.items():
        assert np.all(np.abs(got[name] - w) <= rel * np.abs(w) + floor), f"{what} {name}"


def applied_gradient(ref, run):
    """The gradient the first optimizer step of a `tests/torch_dist.py::
    tiny_steps` run applied: the (mean of the micro-steps') gradient,
    clipped at norm 1 ("accumulate": two micro-steps)."""
    grads = ref["grads"][:2] if run == "accumulate" else ref["grads"][:1]
    g = {n: sum(gs[n] for gs in grads) / len(grads) for n in grads[0]}
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    return {n: v * min(1.0, 1.0 / norm) for n, v in g.items()}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_step_parity(r):
    """Hold a `step_pair` result to the bands of tests/test_torch_train.py:
    metrics rtol 1e-5; every gradient leaf rtol 2e-4 + atol 2e-6·max|g|;
    post-step parameters and EMA within 1e-6 + 1e-3·lr, or 2·lr where
    psd_tpu's clipped gradient is below 1e-6 (Adam's first step,
    lr·g/(|g| + 1e-8), is ill-conditioned there)."""
    j, p, lr = r["jax"], r["port"], r["lr"]
    assert set(p["metrics"]) == set(j["metrics"])
    for k in j["metrics"]:
        np.testing.assert_allclose(p["metrics"][k], j["metrics"][k], rtol=1e-5, err_msg=k)
    jg = dict(leaves(j["grads"]))
    gmax = max(np.abs(v).max() for v in jg.values())
    for name, g in leaves(p["grads"]):
        np.testing.assert_allclose(g, jg[name], rtol=2e-4, atol=2e-6 * gmax, err_msg=name)
    clip = min(1.0, 1.0 / j["metrics"]["grad_norm"])
    jp, je, pe = dict(leaves(j["params"])), dict(leaves(j["ema"])), dict(leaves(p["ema"]))
    for name, v in leaves(p["params"]):
        band = 1e-6 + 1e-3 * lr + 2 * lr * (np.abs(jg[name] * clip) < 1e-6)
        assert np.all(np.abs(v - jp[name]) <= band), name
        assert np.all(np.abs(pe[name] - je[name]) <= band), name
    assert p["step"] == j["step"] == 1 and p["ema_count"] == j["ema_count"] == 1


def as_flax(module, init_fn, *args):
    """`module`'s tensors in the layout of psd_tpu's `init_fn(key, *args)`
    tree ({"params": ...}; `jax.eval_shape`, no JAX init runs), zeros for
    leaves the module lacks. Buffers (the int8 weights) are not leaves."""
    from psd_tpu_torch.convert.from_jax import torch_key

    def shapes(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from shapes(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    like = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    tensors = {k: v.float() for k, v in module.state_dict().items()}
    for path, leaf in shapes(like["params"]):
        key, perm = torch_key(path, len(leaf.shape))
        if key not in tensors:
            shape = leaf.shape if perm is None else tuple(leaf.shape[i] for i in perm)
            tensors[key] = torch.zeros(shape)
    return {"params": to_flax_tree(tensors, like)}


# ---- psd_tpu's int8 activation codes ---------------------------------------------------
def record_psd_tpu(fn, *args):
    """Run psd_tpu's `fn(*args)`, jitted, recording every activation
    quantization (qdense's per-row, qconv3x3's per-sample: int8 codes and
    fp32 scales, in call order, by ordered debug callbacks) → (its output,
    the records)."""
    import psd_tpu.ops.quant as jquant

    seen = []
    rows, conv = jquant.quant_rows, jquant.qconv3x3

    def record(q, s):
        jax.debug.callback(lambda q, s: seen.append((np.asarray(q), np.asarray(s))), q, s,
                           ordered=True)

    def recording_rows(x):
        q, s = rows(x)
        record(q, s)
        return q, s

    def recording_conv(x, w, b=None, stride=1, out_dtype=None):
        xf = x.astype(jnp.float32)  # psd_tpu's per-sample quantization, ops/quant.py:120-123
        sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True), 1e-8) * (1 / 127)
        record(jnp.round(xf / sx).astype(jnp.int8), sx)
        return conv(x, w, b, stride, out_dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "quant_rows", recording_rows)
        mp.setattr(jquant, "qconv3x3", recording_conv)
        out = np.asarray(jax.jit(fn)(*args))
        jax.effects_barrier()
    assert seen
    return out, seen


def on_psd_tpu_codes(seen, port_run):
    """Run the port with each of its activation quantizations replaced by
    psd_tpu's record of the same call (a row-parallel site under tp takes
    its rank's columns: tests/torch_dist.py::handed_codes) → (output, count
    of the port's own codes that differ from psd_tpu's, count of codes)."""
    from tests.torch_dist import handed_codes

    with handed_codes(seen) as count, torch.no_grad():
        out = port_run().numpy()
    assert count["calls"] == len(seen)
    return out, count["differ"], count["codes"]


# ---- the tp train step -------------------------------------------------------------------
def batch_of(seed: int, B: int = 8):
    """A global batch of B rows (4 or 8 a rank) for the tiny model's steps."""
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
            "labels": rng.uniform(0.0, 3.0, B).astype(np.float32),
            "clip_feats": rng.standard_normal((B, 17, 32)).astype(np.float32)}


def psd_tpu_tp_step(tmp, dp: int, fsdp: int):
    """Four ranks at (dp, fsdp, tp 2) on JAX's draws started first, then one
    step of psd_tpu's sharded step on the same mesh shape beside them. →
    (psd_tpu's step and tree layout, the ranks' results, the lr)."""
    from psd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
    from psd_tpu_torch.testing import tiny_dadd
    from tests.torch_dist import Ranks, tiny_steps

    jm = jax_tiny_dadd()
    port = tiny_dadd(for_training=True, seed=0)
    configure(jm.cfg, port.cfg)
    batch, key = batch_of(11), jax.random.PRNGKey(3)
    like = jax.eval_shape(lambda k: jm.init_core(k, 32), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": to_flax_tree(dict(port.core.named_parameters()), like)})
    draws, r_embed = jax_draws(jm, key, batch)
    draws["aoe_noise"] = record_aoe_noise(jm, params, batch, draws["drop_mask"], r_embed, jit=True)
    four = Ranks(tiny_steps, 4, tmp, dp, fsdp, OVERRIDES, [batch], 1, False, [draws], 2)
    jax_step, like = jax_sharded_step(jm, port, batch, key, JaxMeshConfig(dp=dp, fsdp=fsdp, tp=2))
    return jax_step, like, four, jm.cfg.optimizer.lr


def assert_tp_step_parity(jax_step, like, ranks, lr):
    """`assert_step_parity` of rank 0's gathered step against psd_tpu's, the
    clip active; every rank gathers the same parameters."""
    p = ranks[0]

    def tree(arrays):
        return to_flax_tree({k: torch.from_numpy(v) for k, v in arrays.items()}, like)

    r = {"jax": jax_step,
         "port": {"metrics": p["metrics"][0], "grads": tree(p["grads"][0]),
                  "params": tree(p["states"][0]["params"]), "ema": tree(p["states"][0]["ema"]),
                  "ema_count": p["states"][0]["ema_count"], "step": 1},
         "lr": lr}
    assert r["jax"]["metrics"]["grad_norm"] > 1.0  # the clip is active
    assert_step_parity(r)
    for q in ranks[1:]:
        for name, v in p["states"][0]["params"].items():
            np.testing.assert_array_equal(q["states"][0]["params"][name], v, err_msg=name)
