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
