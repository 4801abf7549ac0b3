"""Port modules vs psd_tpu, on the CPU in fp32, with bridged parameters.

The JAX side builds its random-init parameters; `convert/from_jax.py` copies
them into the port; both sides get the same numpy inputs (default_rng).
Tolerances: rtol 2e-4 / atol 2e-5 for whole networks (the band of
tests/test_golden_unet.py: fp32 math in another summation order, through
tens of layers); tighter where a single op is compared.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import sd14_unet_config as jax_sd14
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.models.vae import AutoencoderKL
from psd_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from psd_tpu.ops.norms import group_norm as jax_group_norm
from psd_tpu.ops.upconv import upsample2x_conv3x3_reference as jax_upconv
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import (
    load_flax_,
    state_dict_from_flax,
    torch_key,
    vae_decode_tree,
)
from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.diffusion.schedule import NoiseSchedule, ddim_timesteps
from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config, tiny_unet_config
from psd_tpu_torch.models.vae import VAEDecode, tiny_vae_config
from psd_tpu_torch.ops.norms import group_norm
from psd_tpu_torch.ops.upconv import upsample2x_conv3x3
from psd_tpu_torch.testing import tiny_dadd

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
SPLIT3 = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _count(shapes):
    return sum(int(np.prod(s)) for s in shapes)


# ---- config and schedule -----------------------------------------------------
def test_config_loads_train_ip_unchanged():
    cfg = load_config(ROOT / "configs" / "train_ip.yaml", ["dataset.image_size=512"])
    assert cfg.optimizer.lr == pytest.approx(1e-4)
    assert cfg.model.use_routing_gates and cfg.dataset.image_size == 512
    assert cfg.model.gate_init_anatomy == (0.1, 0.9)


def test_schedule_and_timesteps_match_psd_tpu():
    from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
    from psd_tpu.diffusion.schedule import ddim_timesteps as jax_ts

    np.testing.assert_array_equal(NoiseSchedule().alphas_cumprod,
                                  JaxSchedule().alphas_cumprod)
    np.testing.assert_array_equal(ddim_timesteps(1000, 50), jax_ts(1000, 50))


def test_ddim_sample_matches_psd_tpu():
    """A linear eps function through 6 DDIM steps: the loop and the scan
    agree to fp32 rounding (rtol 1e-6)."""
    from psd_tpu.diffusion.sampler import SamplerConfig as JSC
    from psd_tpu.diffusion.sampler import ddim_sample as jax_ddim
    from psd_tpu_torch.diffusion.sampler import SamplerConfig, ddim_sample

    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    sched = NoiseSchedule()
    out_t = ddim_sample(lambda x, t, i: 0.3 * x + 0.01 * t[:, None, None, None],
                        torch.from_numpy(x), sched, SamplerConfig(6)).numpy()
    from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule

    out_j = np.asarray(jax_ddim(lambda x, t, i: 0.3 * x + 0.01 * t[:, None, None, None],
                                jnp.asarray(x), JaxSchedule(), JSC(6)))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)


# ---- plain ops -------------------------------------------------------------------
@pytest.mark.parametrize("shift", [False, True])
def test_group_norm_fold_matches_psd_tpu(shift):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 8, 8, 64)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    sh = rng.standard_normal((2, 64)).astype(np.float32) if shift else None
    ref = jax_group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-5,
                         shift=None if sh is None else jnp.asarray(sh))
    out = group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 32, 1e-5,
                     shift=None if sh is None else torch.from_numpy(sh))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_upsample_conv_matches_psd_tpu_oracle():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = jax_upconv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    out = upsample2x_conv3x3(torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---- bridge --------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tiny():
    model = jax_tiny_dadd()
    core = model.init_core(jax.random.PRNGKey(0), image_size=32)
    vae = model.vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                         jax.random.PRNGKey(2))
    return model, jax.device_get(core), jax.device_get(vae)


def test_bridge_consumes_every_leaf_once(jax_tiny):
    _, core, vae = jax_tiny
    port = tiny_dadd(seed=None)
    for tree, module in ((core, port.core), (vae_decode_tree(vae), port.vae)):
        leaves = list(_leaves(tree["params"] if "params" in tree else tree))
        sd = state_dict_from_flax(tree, module)
        assert len(sd) == len(leaves) == len(module.state_dict())
        for path, leaf in leaves:
            key, perm = torch_key(path, np.ndim(leaf))
            shape = np.shape(leaf) if perm is None else tuple(np.shape(leaf)[p] for p in perm)
            assert tuple(sd[key].shape) == shape


def test_bridge_raises_on_stray_and_missing_leaves(jax_tiny):
    _, core, _ = jax_tiny
    port = tiny_dadd(seed=None)
    stray = {"params": dict(core["params"], extra={"kernel": np.zeros((2, 2))})}
    with pytest.raises(KeyError, match="no such port parameter"):
        state_dict_from_flax(stray, port.core)
    partial = {"params": {k: v for k, v in core["params"].items() if k != "feature_purifier"}}
    with pytest.raises(KeyError, match="not filled"):
        state_dict_from_flax(partial, port.core)


@pytest.mark.parametrize("mode", ["plain", "split3"])
def test_sd_scale_shapes_without_allocation(mode):
    """jax.eval_shape vs a meta-device port UNet: the same parameter count
    (SD v1.4's 859,520,964 in plain mode) and every shape through the bridge."""
    kw = {} if mode == "plain" else dict(attn_mode="split3")
    n_tok = 77 if mode == "plain" else 48
    jm = JaxUNet(jax_sd14(**kw))
    tree = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                                            jnp.zeros((1, n_tok, 768)), 0.0),
                          jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        tm = UNet2DCondition(sd14_unet_config(**kw))
    port = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    mapped = {}
    for path, leaf in _leaves(tree):
        key, perm = torch_key(path, len(leaf.shape))
        mapped[key] = leaf.shape if perm is None else tuple(leaf.shape[p] for p in perm)
    assert mapped == port
    assert _count(port.values()) == _count(mapped.values())
    if mode == "plain":
        assert _count(port.values()) == 859_520_964


# ---- networks ------------------------------------------------------------------
def test_tiny_split3_unet_eps_parity():
    kw = dict(SPLIT3, gate_init_anatomy=(0.9, 0.1), gate_init_disease=(0.1, 0.9))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = JaxUNet(jax_tiny_unet(**kw))
    params = jm.init(jax.random.PRNGKey(2), x, t, ctx, 0.0)
    tm = load_flax_(UNet2DCondition(tiny_unet_config(**kw)), jax.device_get(params))
    for ds in (0.0, 1.3):
        ref = np.asarray(jm.apply(params, x, t, ctx, jnp.float32(ds)))
        with torch.no_grad():
            out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), ds)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_tiny_vae_decode_parity():
    jcfg = jax_tiny_vae()
    vae = AutoencoderKL(jcfg)
    params = vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(2))
    z = np.random.default_rng(5).standard_normal((2, 16, 16, 4)).astype(np.float32)
    ref = np.asarray(vae.apply(params, jnp.asarray(z), method=vae.decode))
    port = load_flax_(VAEDecode(tiny_vae_config()), vae_decode_tree(jax.device_get(params)))
    with torch.no_grad():
        out = port(torch.from_numpy(z)).numpy()
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("zero_aoe,zero_image", [(False, False), (True, False), (False, True)])
def test_prepare_inference_cond_parity(jax_tiny, zero_aoe, zero_image):
    """AOE, IP-Plus, purifier and delta tokens on tiny_dadd(); fp32 all the
    way, rtol 1e-5 / atol 1e-5."""
    model, core, vae = jax_tiny
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((3, 17, 32)).astype(np.float32)
    tgt = np.array([0.0, 1.5, 3.0], np.float32)
    src = np.array([1.0, 1.5, 0.25], np.float32)
    ref = np.asarray(model.prepare_inference_cond(
        core, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(feats),
        zero_aoe=zero_aoe, zero_image=zero_image))
    port = tiny_dadd(seed=None).load_flax(core, vae)
    out = port.prepare_inference_cond(tgt, src, feats, zero_aoe=zero_aoe,
                                      zero_image=zero_image).numpy()
    assert out.shape == (3, 12, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # equal source and target → the delta segment is exactly zero
    assert np.all(out[1, 8:] == 0.0)
