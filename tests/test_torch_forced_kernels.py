"""UNet and train-step parity runs with psd_tpu's Pallas kernels really on.

PSD_TPU_FORCE_KERNELS=interpret makes psd_tpu's dispatch gates treat the CPU
as kernel-capable (core/mode.py:62, as tests/test_mesh_kernels.py does). The
shapes pass the gates: widths (64, 128), a 32×32 latent, batch 1, so the JAX
side runs spattn (S=1024), split3 (S=1024 and 256), ln_proj and ln_geglu
(M=1024, C=64) and gn_proj (S=1024 and 256) in interpret mode. The port runs
the same sites through its kernel wrappers, whose CPU path is the plain
version. Tolerance rtol 2e-4 / atol 2e-5 (the UNet band).

In training psd_tpu keeps split3 on (its Pallas forward, an XLA backward
under jax.grad) and turns spattn, the LN kernels and gn_proj off; the
stock flash kernel needs a real TPU and takes the XLA path here. The port's
train step runs split3 through its autograd.Function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu_torch.convert.from_jax import load_flax_
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.ops import kernels

KW = dict(block_out_channels=(64, 128), attn_mode="split3", num_aoe_tokens=4,
          num_image_tokens=4, num_delta_tokens=4, gate_init_anatomy=(0.8, 0.3),
          gate_init_disease=(0.2, 0.7))


def test_unet_parity_with_pallas_kernels_on(monkeypatch):
    monkeypatch.setenv("PSD_TPU_FORCE_KERNELS", "interpret")
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    t = np.array([321], np.int32)
    ctx = rng.standard_normal((1, 12, 32)).astype(np.float32)
    jm = JaxUNet(jax_tiny_unet(**KW))
    params = jm.init(jax.random.PRNGKey(4), x, t, ctx, 0.0)

    def f(p, x):
        return jm.apply(p, x, t, ctx, jnp.float32(1.0))

    # spattn, split3, ln_proj, ln_geglu and gn_proj at every Transformer2D
    # (+ the stock flash kernel nowhere: its gate needs a real TPU)
    jaxpr = str(jax.make_jaxpr(f)(params, x))
    assert jaxpr.count("pallas_call") >= 5
    for name in ("_spattn", "split3_attention", "ln_proj", "ln_geglu", "gn_proj"):
        assert f"name={name}" in jaxpr, name
    ref = np.asarray(jax.jit(f)(params, x))
    tm = load_flax_(UNet2DCondition(tiny_unet_config(**KW)), jax.device_get(params))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 1.0).numpy()
    # CPU tensors take the plain versions: nothing was launched
    assert sum(kernels.launch_counts.values()) == 0
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_cpu_wrappers_never_build(monkeypatch):
    """On CPU tensors the wrappers must not reach nvcc or ctypes."""
    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(kernels, "library", boom)
    tm = UNet2DCondition(tiny_unet_config(**KW))
    with torch.no_grad():
        out = tm(torch.zeros(1, 32, 32, 4), torch.tensor([5]), torch.zeros(1, 12, 32), 1.0)
    assert out.shape == (1, 32, 32, 4)


@pytest.mark.parametrize("name", ["attention", "split3", "ln_proj", "ln_geglu",
                                  pytest.param("gn_proj", id="gnproj")])
def test_kill_switch_names(name):
    from psd_tpu_torch.core.mode import disable_kernels as port_disable
    from psd_tpu_torch.core.mode import kernel_disabled, training_mode, use_kernel

    assert not kernel_disabled(name) and use_kernel(name)
    with port_disable(name):
        assert not use_kernel(name)
    assert use_kernel(name)
    # in training psd_tpu keeps the kernels with a backward (split3, flash)
    with training_mode():
        assert use_kernel(name) == (name in ("attention", "split3"))


def test_train_step_parity_with_pallas_kernels_on(monkeypatch):
    """One make_train_step on each side on the tiny config with latents
    (1, 16, 16, 4), so split3 at S = 256 passes its gate (the only kernel
    psd_tpu's train step runs on the CPU), with the tolerances of
    tests/test_torch_train.py::test_train_step_matches_psd_tpu."""
    from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
    from psd_tpu_torch.testing import tiny_dadd
    from tests.torch_parity import assert_step_parity, configure, step_pair

    monkeypatch.setenv("PSD_TPU_FORCE_KERNELS", "interpret")
    gates = dict(gate_init_anatomy=(0.8, 0.3), gate_init_disease=(0.2, 0.7))
    jm = jax_tiny_dadd(**gates)
    port = tiny_dadd(for_training=True, seed=7, **gates)
    configure(jm.cfg, port.cfg)
    rng = np.random.default_rng(13)
    batch = {"latents": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
             "labels": np.array([2.5], np.float32),
             "clip_feats": rng.standard_normal((1, 17, 32)).astype(np.float32)}
    kernels.reset_launch_counts()
    r = step_pair(jm, port, batch)
    assert sum(kernels.launch_counts.values()) == 0
    assert_step_parity(r)
