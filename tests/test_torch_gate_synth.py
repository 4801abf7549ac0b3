"""The stride gate's synthetic training (`scripts/torch_check_stride_quality.py`:
`synth_batch`, `synth_optimizer`) against psd_tpu's
(`scripts/check_stride_quality.py`): the class-structured batch and the LR
of each step. Apart from tests/test_torch_gates.py, whose run of both
stride gates takes most of its time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_gates import stride_module


def test_synth_batch_is_psd_tpus_formula():
    """Given labels, the base draw, the anchors and the feature noise, the
    port's class-structured batch equals psd_tpu's `make_batch` formula
    (`check_stride_quality.py:121-134`, a closure there, written out
    here)."""
    pmod = stride_module()
    rng = np.random.default_rng(0)
    B, lat, n_cls, n_pos, c_dim = 5, 16, 4, 3, 8
    labels = rng.integers(0, n_cls, B)
    base = rng.standard_normal((B, lat // 4, lat // 4, 4)).astype(np.float32)
    anchors = rng.standard_normal((n_cls, n_pos, c_dim)).astype(np.float32)
    noise = rng.standard_normal((B, n_pos, c_dim)).astype(np.float32)

    jl = jnp.asarray(labels)
    field = jax.image.resize(jnp.asarray(base), (B, lat, lat, 4), "linear")
    amp = (0.5 + 0.35 * jl.astype(jnp.float32))[:, None, None, None]
    bias = 0.3 * (jl.astype(jnp.float32) - (n_cls - 1) / 2)
    want = {"latents": amp * field + bias[:, None, None, None],
            "labels": jl.astype(jnp.float32),
            "clip_feats": jnp.asarray(anchors)[jl] + 0.1 * jnp.asarray(noise)}
    got = pmod.synth_batch(torch.from_numpy(labels), torch.from_numpy(base),
                           torch.from_numpy(anchors), torch.from_numpy(noise), lat, n_cls)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("steps", [20, 500])
def test_synth_train_lr_sequence_is_psd_tpus(steps):
    """The LRs each of `steps` synth-train steps sets (both groups; the
    gates' `Config()`), against psd_tpu's optax chain built as its
    synth_train builds it, read off the update of zero gradients (AdamW's
    step is then its weight decay alone: −lr·wd·p)."""
    from psd_tpu.core.config import Config as JaxConfig
    from psd_tpu.train import build_optimizer as jax_build_optimizer

    pmod = stride_module()
    cfg, jcfg = pmod.Config(), JaxConfig()
    tx = pmod.synth_optimizer(cfg, steps)
    # a module with a parameter in each LR group (the core's names)
    module = torch.nn.ModuleDict({"image_projection": torch.nn.Linear(1, 1),
                                  "unet": torch.nn.Linear(1, 1)})
    opt = tx.init(module)
    got = []
    for _ in range(steps):
        tx.set_lr(opt)
        got.append({g["label"]: float(g["lr"]) for g in opt.adamw.param_groups})
        tx.advance(opt, True)

    jtx = jax_build_optimizer(jcfg, steps_per_epoch=max(steps // jcfg.training.max_epochs, 1))
    params = {"image_projection": {"w": jnp.ones(())}, "unet": {"w": jnp.ones(())}}
    opt_state = jtx.init(params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    update = jax.jit(jtx.update)
    wd = jcfg.optimizer.weight_decay
    for i in range(steps):
        upd, opt_state = update(zeros, opt_state, params)
        want = {"x1": -float(upd["unet"]["w"]) / wd, "x2": -float(upd["image_projection"]["w"]) / wd}
        for lab in want:
            np.testing.assert_allclose(got[i][lab], want[lab], rtol=1e-5, err_msg=f"{lab} {i}")
