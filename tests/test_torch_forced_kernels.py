"""One UNet parity run with psd_tpu's Pallas kernels really on.

PSD_TPU_FORCE_KERNELS=interpret makes psd_tpu's dispatch gates treat the CPU
as kernel-capable (core/mode.py:62, as tests/test_mesh_kernels.py does), and
`disable_kernels("gnproj")` takes the configuration this port runs. The
shapes pass the gates: widths (64, 128), a 32×32 latent, batch 1, so the JAX
side runs spattn (S=1024), split3 (S=1024 and 256), ln_proj and ln_geglu
(M=1024, C=64) in interpret mode. The port runs the same sites through its
kernel wrappers, whose CPU path is the plain version.
Tolerance rtol 2e-4 / atol 2e-5 (the UNet band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.core.mode import disable_kernels
from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu_torch.convert.from_jax import load_flax_
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.ops import kernels

KW = dict(block_out_channels=(64, 128), attn_mode="split3", num_aoe_tokens=4,
          num_image_tokens=4, num_delta_tokens=4, gate_init_anatomy=(0.8, 0.3),
          gate_init_disease=(0.2, 0.7))


def _pallas_calls(fn, *args):
    return str(jax.make_jaxpr(fn)(*args)).count("pallas_call")


def test_unet_parity_with_pallas_kernels_on(monkeypatch):
    monkeypatch.setenv("PSD_TPU_FORCE_KERNELS", "interpret")
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    t = np.array([321], np.int32)
    ctx = rng.standard_normal((1, 12, 32)).astype(np.float32)
    jm = JaxUNet(jax_tiny_unet(**KW))
    with disable_kernels("gnproj"):
        params = jm.init(jax.random.PRNGKey(4), x, t, ctx, 0.0)

        def f(p, x):
            return jm.apply(p, x, t, ctx, jnp.float32(1.0))

        # spattn, split3 ×3 sites, ln_proj ×4, ln_geglu ×2 (+ the stock
        # flash kernel nowhere: its gate needs a real TPU)
        assert _pallas_calls(f, params, x) >= 4
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


@pytest.mark.parametrize("name", ["attention", "split3", "ln_proj", "ln_geglu", "gnproj"])
def test_kill_switch_names(name):
    from psd_tpu_torch.core.mode import disable_kernels as port_disable
    from psd_tpu_torch.core.mode import kernel_disabled, use_kernel

    assert kernel_disabled("gnproj")  # not ported: off by configuration
    with port_disable(name):
        assert not use_kernel(name)
    assert use_kernel(name) == (name != "gnproj")
