"""The port's training slice vs psd_tpu, on the CPU in fp32.

Inputs from numpy's default_rng; JAX's random draws handed to the port
(tests/torch_parity.py). Tolerances, with their reasons:
  * schedule, LR, EMA, clip: rtol 1e-6 (the same fp32 or float64 formula);
  * attention / split3 gradients: rtol 1e-5, atol 1e-5 (fp32 math in
    another summation order, like the forward tests of test_torch_kernels);
  * the train step: loss and metrics rtol 1e-5; every gradient leaf within
    rtol 2e-4 + atol 2e-6·max|g| (fp32 backward through the tiny UNet: the
    UNet band; the worst leaf measured at ≈ 1/6 of it); post-step
    parameters and EMA within 1e-6 + 1e-3·lr, except where psd_tpu's
    clipped gradient is below 1e-6: there Adam's first step,
    lr·g/(|g| + 1e-8), turns an fp32 rounding difference of g into up to
    2·lr (such gradients are rounding noise, e.g. the attention key biases,
    whose exact gradient is 0 by softmax shift invariance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from psd_tpu.ops.attention import dot_product_attention as jax_attention
from psd_tpu.ops.split3 import split3_attention as jax_split3
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu.train import ema_init as jax_ema_init
from psd_tpu.train import ema_update as jax_ema_update
from psd_tpu.train import warmup_cosine_epochwise as jax_schedule
from psd_tpu_torch.core.mode import training_mode
from psd_tpu_torch.diffusion.schedule import NoiseSchedule
from psd_tpu_torch.ops import attention, split3
from psd_tpu_torch.testing import tiny_dadd
from psd_tpu_torch.train import (
    build_optimizer,
    clip_by_global_norm_,
    ema_init,
    ema_update,
    group_label,
    warmup_cosine_epochwise,
)
from tests.torch_parity import assert_step_parity, configure, step_pair


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- schedule, optimizer, EMA --------------------------------------------------------
def test_q_sample_and_min_snr_weight_match_psd_tpu():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 17, 500, 999], np.int32)
    js, ts = JaxSchedule(), NoiseSchedule()
    np.testing.assert_array_equal(ts.snr, js.snr)
    ref = np.asarray(js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    out = ts.q_sample(_t(x0), _t(t), _t(noise)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    for gamma in (1.0, 5.0):
        ref = np.asarray(js.min_snr_weight(jnp.asarray(t), gamma))
        np.testing.assert_allclose(ts.min_snr_weight(_t(t), gamma).numpy(), ref, rtol=1e-6)


def test_lr_schedule_matches_psd_tpu():
    args = dict(base_lr=1e-4, warmup_epochs=2, max_epochs=10, steps_per_epoch=100, min_lr=1e-6)
    ref, port = jax_schedule(**args), warmup_cosine_epochwise(**args)
    for step in (0, 99, 100, 150, 200, 450, 999, 1000, 5000):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6)


def test_optimizer_groups_double_lr_for_projection_and_purifier():
    assert group_label("image_projection.layers_0_ff_0.weight") == "x2"
    assert group_label("feature_purifier.gate_0.bias") == "x2"
    assert group_label("unet.conv_in.weight") == "x1"
    assert group_label("ordinal_embedder.deltas") == "x1"
    model = tiny_dadd(for_training=True)
    tx = build_optimizer(model.cfg, steps_per_epoch=10)
    opt = tx.init(model.core).adamw
    by_label = {g["label"]: g for g in opt.param_groups}
    n_x2 = sum(p.numel() for n, p in model.core.named_parameters()
               if n.startswith(("image_projection.", "feature_purifier.")))
    assert sum(p.numel() for p in by_label["x2"]["params"]) == n_x2
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.core.parameters()))
    assert by_label["x2"]["lr"] == pytest.approx(2 * by_label["x1"]["lr"])


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_by_global_norm_matches_optax(norm):
    rng = np.random.default_rng(int(norm * 10))
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    scale = norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs))
    gs = [g * np.float32(scale) for g in gs]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
    port = [_t(g.copy()) for g in gs]
    before = clip_by_global_norm_(port, 1.0)
    np.testing.assert_allclose(float(before), norm, rtol=1e-5)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_ema_gating_matches_psd_tpu():
    """Before the start step nothing; the first update copies; off-cycle
    steps skip; later updates blend (psd_tpu's sequence, tests/test_train.py)."""
    jema = jax_ema_init({"w": jnp.ones((4,))})
    pema = ema_init({"w": torch.ones(4)})
    for step, val, decay in ((10, 5.0, 0.999), (100, 5.0, 0.999), (101, 9.0, 0.999),
                             (104, 9.0, 0.9), (108, 2.0, 0.9)):
        jema = jax_ema_update(jema, {"w": jnp.full((4,), val)}, jnp.asarray(step),
                              decay=decay, start_step=100, every=4)
        pema = ema_update(pema, {"w": torch.full((4,), val)}, step, decay=decay,
                          start_step=100, every=4)
        assert pema.count == int(jema.count)
        np.testing.assert_allclose(pema.params["w"].numpy(), np.asarray(jema.params["w"]),
                                   rtol=1e-6)
    assert pema.count == 3


# ---- gradients through the kernel sites ------------------------------------------------
@pytest.mark.parametrize("S,D", [(512, 40), (512, 80)])
def test_attention_grads_match_jax_vjp(S, D):
    """The FlashAttention autograd.Function (CPU: plain forward + autograd
    through the plain version) vs jax.vjp of psd_tpu's attention XLA path."""
    rng = np.random.default_rng(S + D)
    q, k, v, g = (rng.standard_normal((2, S, 2, D)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(jax_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    qkv = [_t(a).requires_grad_(True) for a in (q, k, v)]
    with training_mode():
        assert attention.kernel_route(qkv[0], qkv[1], training=True) == "flash"
        o = attention.FlashAttention.apply(*qkv, None)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(o, qkv, _t(g))
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # the backward wrapper's CPU path, given the forward's lse
    _, lse = attention.attention_fwd(*[t.detach() for t in qkv], return_lse=True)
    lse_ref = jax.nn.logsumexp(jnp.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5, -1) / np.log(2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,route", [
    ((64, 1024, 8, 40), "flash"),
    ((8, 4096, 8, 40), "flash"),
    ((8, 1024, 8, 80), "flash"),
    ((64, 256, 8, 80), None),
])
def test_attention_training_route_is_stock_flash(shape, route):
    q = torch.empty(shape, device="meta")
    assert attention.kernel_route(q, q, training=True) == route


@pytest.mark.parametrize("delta", [0.0, 1.3])
def test_split3_grads_match_pallas_vjp(delta):
    """Split3Attention (kernel forward, plain-version backward; on the CPU
    both plain) vs jax.vjp of the Pallas kernel in interpret mode, whose
    custom VJP back-propagates through XLA math."""
    rng = np.random.default_rng(5 + int(delta * 10))
    B, S, H, D, K = 2, 256, 2, 40, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    banks = [rng.standard_normal((B, K, H, D)).astype(np.float32) for _ in range(6)]
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def f(q, *banks):
        return jax_split3(q, *banks, jnp.float32(delta), 0.9, 0.2, None, 128, True)

    out, vjp = jax.vjp(f, jnp.asarray(q), *map(jnp.asarray, banks))
    ref = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_(True) for a in [q] + banks]
    o = split3.split3_attention(*ins, delta, 0.9, 0.2)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    for a, b in zip(torch.autograd.grad(o, ins, _t(g)), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ---- the train step ----------------------------------------------------------------
def test_train_step_matches_psd_tpu():
    """One make_train_step on tiny_dadd() on each side: loss and metrics,
    every gradient leaf, the post-step parameters and the EMA (its first
    update, a copy)."""
    jm = jax_tiny_dadd()
    port = tiny_dadd(for_training=True, seed=0)
    configure(jm.cfg, port.cfg)
    rng = np.random.default_rng(11)
    batch = {"latents": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
             "labels": np.array([0.0, 1.5, 2.0, 3.0], np.float32),
             "clip_feats": rng.standard_normal((4, 17, 32)).astype(np.float32)}
    r = step_pair(jm, port, batch)
    assert r["jax"]["metrics"]["grad_norm"] > 1.0  # the clip is active
    assert 0.0 < r["jax"]["metrics"]["cfg_drop_rate"] < 1.0  # the drop mask matters
    assert_step_parity(r)


def test_train_step_moves_params_and_ema_blends():
    """Two port steps from a generator: finite loss, parameters move, the
    EMA copies at its first update and blends at the second."""
    from psd_tpu_torch.train import create_train_state, make_train_step

    model = tiny_dadd(for_training=True, seed=1)
    configure(model.cfg)
    state, tx = create_train_state(model, steps_per_epoch=10, seed=0)
    step = make_train_step(model, tx)
    rng = np.random.default_rng(2)
    batch = {"latents": _t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
             "labels": torch.tensor([0.0, 3.0]),
             "clip_feats": _t(rng.standard_normal((2, 17, 32)).astype(np.float32))}
    w = model.core.unet.conv_in.weight
    w0 = w.detach().clone()
    state, m1 = step(state, batch)
    w1 = w.detach().clone()
    np.testing.assert_array_equal(state.ema.params["unet.conv_in.weight"].numpy(), w1.numpy())
    state, m2 = step(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["grad_norm"]))
    assert not torch.equal(w0, w1) and not torch.equal(w1, w.detach())
    d = model.cfg.training.ema_decay
    np.testing.assert_allclose(state.ema.params["unet.conv_in.weight"].numpy(),
                               (d * w1 + (1 - d) * w.detach()).numpy(), rtol=1e-6, atol=1e-8)
    assert state.ema.count == 2 and state.opt_state.count == 2


def test_gradient_checkpointing_is_the_same_math():
    """remat=True (torch.utils.checkpoint, kernel flags carried into the
    recomputation) gives the loss and gradients of remat=False."""
    rng = np.random.default_rng(4)
    batch = {"latents": _t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
             "labels": torch.tensor([1.0, 2.0]),
             "clip_feats": _t(rng.standard_normal((2, 17, 32)).astype(np.float32))}
    out = []
    for remat in (False, True):
        model = tiny_dadd(for_training=True, seed=3, remat=remat)
        draws = model.sample_draws((2, 8, 8, 4), torch.Generator().manual_seed(0))
        with training_mode():
            loss, _ = model.train_loss(batch, draws=draws)
            loss.backward()
        out.append((loss.item(), [p.grad.clone() for p in model.core.unet.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_aoe_training_noise():
    """The embedder noise enters before the projector at std 0.005; its
    draws come from the generator as N(0, 1)."""
    model = tiny_dadd(for_training=True, seed=0)
    draws = model.sample_draws((256, 8, 8, 4), torch.Generator().manual_seed(5))
    n = draws["aoe_noise"]
    assert n.shape == (2, 256, 32)
    assert abs(n.mean().item()) < 0.02 and abs(n.std().item() - 1.0) < 0.02
    emb = model.core.ordinal_embedder
    labels = torch.full((4,), 1.5)
    with torch.no_grad():
        clean = emb(labels)
        noisy = emb(labels, n[0, :4])
        table = emb.class_table()
        from psd_tpu_torch.conditioning.ordinal import interp_table

        want = emb._project(interp_table(table, labels) + 0.005 * n[0, :4])
    assert not torch.equal(clean, noisy)
    torch.testing.assert_close(noisy, want, rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    """DADD's default device is "cuda"; without a card it raises instead of
    carrying on on the CPU. device="cpu" is an explicit choice."""
    from psd_tpu_torch.core.config import Config
    from psd_tpu_torch.diffusion.dadd import DADD

    if torch.cuda.is_available():
        assert tiny_dadd(device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DADD(Config(), core_cfg=tiny_dadd(seed=None).core_cfg)
    assert tiny_dadd().device.type == "cpu"
    with pytest.raises(ValueError, match="for_training"):
        tiny_dadd().train_loss({"latents": torch.zeros(1, 8, 8, 4), "labels": torch.zeros(1)},
                               generator=torch.Generator())


def test_gradient_accumulation_matches_optax_multisteps():
    """accumulate_grad_batches = 2: psd_tpu's MultiSteps(chain(clip,
    multi_transform(adamw ×1/×2))) vs the port's Optimizer, fed the same
    four micro-gradients (two of them above the clip); parameters after each
    micro-step within atol 1e-6 (fp32, lr 1e-2, the same update formula)."""
    from psd_tpu.core.config import Config as JaxConfig
    from psd_tpu.train import build_optimizer as jax_build_optimizer
    from psd_tpu_torch.core.config import Config

    jcfg, pcfg = JaxConfig(), Config()
    for cfg in (jcfg, pcfg):
        cfg.training.accumulate_grad_batches = 2
        cfg.optimizer.lr = 1e-2
        cfg.scheduler.warmup_epochs = 0
    rng = np.random.default_rng(9)
    w_u = rng.standard_normal((3, 4)).astype(np.float32)
    w_i = rng.standard_normal(5).astype(np.float32)
    jparams = {"unet": {"w": jnp.asarray(w_u)}, "image_projection": {"w": jnp.asarray(w_i)}}
    jtx = jax_build_optimizer(jcfg, steps_per_epoch=10)
    jstate = jtx.init(jparams)

    module = torch.nn.Module()
    for name, w in (("unet", w_u), ("image_projection", w_i)):
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(_t(w.copy()))
        module.add_module(name, sub)
    tx = build_optimizer(pcfg, steps_per_epoch=10)
    opt = tx.init(module)
    params = list(module.parameters())
    for i, scale in enumerate((0.1, 2.0, 0.3, 1.5)):
        gu = (rng.standard_normal((3, 4)) * scale).astype(np.float32)
        gi = (rng.standard_normal(5) * scale).astype(np.float32)
        upd, jstate = jtx.update({"unet": {"w": jnp.asarray(gu)},
                                  "image_projection": {"w": jnp.asarray(gi)}}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        applied = tx.update(opt, params, [_t(gu), _t(gi)])
        assert applied == (i % 2 == 1) and opt.mini_step == int(jstate.mini_step)
        np.testing.assert_allclose(module.unet.w.detach().numpy(),
                                   np.asarray(jparams["unet"]["w"]), atol=1e-6)
        np.testing.assert_allclose(module.image_projection.w.detach().numpy(),
                                   np.asarray(jparams["image_projection"]["w"]), atol=1e-6)
    assert opt.count == 2


def test_ema_counts_optimizer_steps_when_accumulating():
    """With accumulation the EMA gates on optimizer steps: the first micro-
    step updates nothing, the second (the first real step) copies."""
    from psd_tpu_torch.train import create_train_state, make_train_step

    model = tiny_dadd(for_training=True, seed=2)
    configure(model.cfg)
    model.cfg.training.accumulate_grad_batches = 2
    state, tx = create_train_state(model, steps_per_epoch=10, seed=0)
    step = make_train_step(model, tx)
    batch = {"latents": torch.zeros(2, 8, 8, 4), "labels": torch.tensor([0.0, 2.0]),
             "clip_feats": torch.zeros(2, 17, 32)}
    w0 = model.core.unet.conv_in.weight.detach().clone()
    state, _ = step(state, batch)
    assert state.ema.count == 0 and torch.equal(w0, model.core.unet.conv_in.weight.detach())
    state, _ = step(state, batch)
    assert state.ema.count == 1 and state.opt_state.count == 1
    assert not torch.equal(w0, model.core.unet.conv_in.weight.detach())
    np.testing.assert_array_equal(state.ema.params["unet.conv_in.weight"].numpy(),
                                  model.core.unet.conv_in.weight.detach().numpy())


def test_ema_gates_on_the_zero_based_step():
    """Start 0, every 4 (the SD-scale smoke run's gating): over three steps
    the EMA updates once, at step 0, as psd_tpu's step gates on its 0-based
    `state.step`; gated on the optimizer's 1-based count it would update
    never. The average is then the parameters after step 0."""
    from psd_tpu_torch.train import create_train_state, make_train_step

    model = tiny_dadd(for_training=True, seed=2)
    configure(model.cfg)
    model.cfg.training.update_every_n_steps = 4
    state, tx = create_train_state(model, steps_per_epoch=10, seed=0)
    step = make_train_step(model, tx)
    batch = {"latents": torch.zeros(2, 8, 8, 4), "labels": torch.tensor([0.0, 2.0]),
             "clip_feats": torch.zeros(2, 17, 32)}
    w = model.core.unet.conv_in.weight
    state, _ = step(state, batch)
    w1 = w.detach().clone()
    for _ in range(2):
        state, _ = step(state, batch)
    assert state.ema.count == 1 and state.opt_state.count == 3
    assert not torch.equal(w1, w.detach())
    np.testing.assert_array_equal(state.ema.params["unet.conv_in.weight"].numpy(), w1.numpy())
