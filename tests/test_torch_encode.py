"""The port's VAE encoder, `DADD.encode_latents`, the whole-VAE bridge and
`convert/npz.py` against psd_tpu, on the CPU in fp32.

psd_tpu builds the random-init parameters, the bridge copies them into the
port, both sides take the same numpy inputs (default_rng) and, for the
posterior's draw, JAX's normal values. Tolerances: atol 1e-5 for the tiny
encoder's mean and logvar (fp32 through ~20 layers in another summation
order); the SD-scale model is checked through the bridge without
allocating its weights on a device (meta).
"""

import contextlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.convert.io import save_params_npz
from psd_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from psd_tpu.models.vae import VAEConfig as JaxVAEConfig
from psd_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import load_flax_, state_dict_from_flax, torch_key
from psd_tpu_torch.convert.npz import load_params_npz
from psd_tpu_torch.core import mode
from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.diffusion.dadd import core_config_from
from psd_tpu_torch.models.init import flax_init_
from psd_tpu_torch.models.vae import AutoencoderKL, VAEConfig, VAEDecode, tiny_vae_config
from psd_tpu_torch.ops import attention, geglu, gnproj, kernels, split3
from psd_tpu_torch.ops.attention import fwd_shape_error, kernel_route
from psd_tpu_torch.testing import route_launches, tiny_dadd
from psd_tpu_torch.train import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
SD_VAE_PARAMS = 83_653_863  # diffusers' AutoencoderKL for SD v1.x


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_vae():
    vae = JaxAutoencoderKL(jax_tiny_vae())
    params = vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(2))
    return vae, jax.device_get(params)


def _images(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 32, 3)], ids=["square", "tall"])
def test_tiny_encoder_matches_psd_tpu(jax_vae, shape):
    """(mean, logvar) of AutoencoderKL.encode, the (0, 1) pad of each
    down-sampler included (a 48 × 32 image pads unequal sides)."""
    vae, params = jax_vae
    x = _images(3, shape)
    mean, logvar = vae.apply(params, jnp.asarray(x), method=vae.encode)
    port = load_flax_(AutoencoderKL(tiny_vae_config()), params)
    with torch.no_grad():
        pm, pl = port.encode(torch.from_numpy(x))
    assert pm.dtype == pl.dtype == torch.float32
    assert pm.shape == (shape[0], shape[1] // 2, shape[2] // 2, 4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(logvar), rtol=0, atol=ATOL)


def test_logvar_is_clipped_as_psd_tpu(jax_vae):
    """A quant_conv bias of ±100 on the logvar half pins it to [−30, 20]."""
    vae, params = jax_vae
    params = jax.tree_util.tree_map(np.array, params)
    bias = params["params"]["quant_conv"]["bias"]
    bias[4:6], bias[6:] = 100.0, -100.0
    x = _images(4)
    _, ref = vae.apply(params, jnp.asarray(x), method=vae.encode)
    port = load_flax_(AutoencoderKL(tiny_vae_config()), params)
    with torch.no_grad():
        _, logvar = port.encode(torch.from_numpy(x))
    assert logvar[..., :2].eq(20.0).all() and logvar[..., 2:].eq(-30.0).all()
    np.testing.assert_array_equal(logvar.numpy(), np.asarray(ref))


def test_encode_latents_matches_psd_tpu_with_its_draw(jax_vae):
    """DADD.encode_latents with JAX's normal draw handed over: the
    posterior's sample × latent_scale, fp32 (psd_tpu/diffusion/dadd.py:326)."""
    _, params = jax_vae
    jm = jax_tiny_dadd()
    x = _images(5)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jm.encode_latents(params, jnp.asarray(x), key))
    noise = np.array(jax.random.normal(key, ref.shape, jnp.float32))
    port = tiny_dadd(for_training=True, seed=None).load_flax(vae_tree=params)
    out = port.encode_latents(x, noise=torch.from_numpy(noise))
    assert out.dtype == torch.float32 and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL * port.latent_scale * 4)
    g = torch.Generator().manual_seed(0)
    drawn = port.encode_latents(x, generator=g)
    again = port.encode_latents(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again) and not torch.equal(drawn, out)


def test_training_model_builds_its_frozen_vae_at_first_use():
    """for_training: no VAE until first use, then the whole AutoencoderKL
    from its own generator (seed + 1), frozen; a serving model holds the
    decoder only and refuses to encode."""
    a, b = tiny_dadd(for_training=True, seed=3), tiny_dadd(for_training=True, seed=3)
    assert a._vae is None and a._clip is None
    assert isinstance(a.vae, AutoencoderKL) and a.vae is a.vae
    assert not any(p.requires_grad for p in a.vae.parameters()) and not a.vae.training
    for (ka, va), (kb, vb) in zip(a.vae.state_dict().items(), b.vae.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    expect = AutoencoderKL(tiny_vae_config())
    flax_init_(expect, torch.Generator().manual_seed(4))
    for k, v in expect.state_dict().items():
        assert torch.equal(a.vae.state_dict()[k], v), k
    serving = tiny_dadd(seed=3)
    assert type(serving.vae) is VAEDecode
    with pytest.raises(ValueError, match="encoder"):
        serving.encode_latents(_images(0))


def test_sd_scale_vae_tree_through_the_bridge_strict_both_ways():
    """psd_tpu's whole SD VAE tree (jax.eval_shape, zero-strided leaves)
    into a meta-device AutoencoderKL: every leaf lands, every parameter is
    filled, SD's parameter count; a missing and an extra leaf raise."""
    jv = JaxAutoencoderKL(JaxVAEConfig())
    tree = jax.eval_shape(lambda k: jv.init(k, jnp.zeros((1, 64, 64, 3)), k),
                          jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        port = AutoencoderKL(VAEConfig())
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, leaf in _leaves(tree):
        key, perm = torch_key(path, len(leaf.shape))
        mapped[key] = leaf.shape if perm is None else tuple(leaf.shape[p] for p in perm)
    assert mapped == shapes
    assert sum(int(np.prod(s)) for s in shapes.values()) == SD_VAE_PARAMS

    def zeros(t):
        return {k: zeros(v) if isinstance(v, dict) else np.broadcast_to(np.float32(0), v.shape)
                for k, v in t.items()}

    full = zeros(tree)
    assert set(state_dict_from_flax(full, port)) == set(shapes)
    missing = dict(full, encoder={k: v for k, v in full["encoder"].items() if k != "conv_in"})
    with pytest.raises(KeyError, match="not filled"):
        state_dict_from_flax(missing, port)
    extra = dict(full, encoder=dict(full["encoder"], conv_extra={"bias": np.zeros(4, np.float32)}))
    with pytest.raises(KeyError, match="no such port parameter"):
        state_dict_from_flax(extra, port)


@pytest.mark.parametrize("batch", [64, 4, 13])
def test_encoder_mid_block_routes_to_the_attention_kernel(batch):
    """The SD encoder's mid-block attention at 256² is (B, 1024, 1, 512):
    routed to the kernel (psd_tpu's flash gate, ops/flash.py:52) and
    admitted by its shape check, in serving mode, where encode runs."""
    q = torch.empty((batch, (256 // 8) ** 2, 1, 512), device="meta")
    assert kernel_route(q, q) is not None
    assert fwd_shape_error(1024, 1024, 512) is None


def test_npz_reads_what_psd_tpu_writes(jax_vae, tmp_path):
    _, params = jax_vae
    path = tmp_path / "vae.npz"
    save_params_npz(params, path)
    got = load_params_npz(path)
    want = dict(_leaves(params))
    assert dict(_leaves(got)).keys() == want.keys()
    for k, v in _leaves(got):
        np.testing.assert_array_equal(v, want[k])
    port = tiny_dadd(for_training=True, seed=None).load_flax(vae_tree=got)
    assert torch.equal(port.vae.encoder.conv_in.bias,
                       torch.from_numpy(np.array(params["params"]["encoder"]["conv_in"]["bias"])))


def test_train_loss_takes_the_callers_kernel_mode(monkeypatch):
    """train_loss enters no mode of its own: the train step runs it in
    training mode, a validation loss outside it (serving routes), as
    psd_tpu jits its val loss outside training_mode."""
    seen = []

    def is_training():
        seen.append(mode.is_training())
        return seen[-1]

    # every attention call asks its route in the current mode
    monkeypatch.setattr(attention, "is_training", is_training)
    model = tiny_dadd(for_training=True, seed=1)
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
             "labels": np.array([0.0, 3.0], np.float32),
             "clip_feats": rng.standard_normal((2, 17, 32)).astype(np.float32)}
    with torch.no_grad():
        model.train_loss(batch, generator=torch.Generator().manual_seed(0))
    assert seen and not any(seen)
    seen.clear()
    state, tx = create_train_state(model, steps_per_epoch=2)
    make_train_step(model, tx)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen and all(seen)


def test_train_loss_differentiated_outside_training_mode_gets_the_same_gradients():
    """On the CPU every wrapper runs its plain version, which autograd
    differentiates: a loss differentiated outside training mode gets the
    gradients it gets inside it (fp32; rtol 1e-5, atol 1e-7 for another
    summation order). On the card the forward-only kernels refuse it
    instead (`kernels.require_no_grad`; chip_smoke.py phase 6 checks it)."""
    model = tiny_dadd(for_training=True, seed=1)
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
             "labels": np.array([0.0, 3.0], np.float32),
             "clip_feats": rng.standard_normal((2, 17, 32)).astype(np.float32)}
    draws = model.sample_draws((2, 8, 8, 4), torch.Generator().manual_seed(0))
    params = list(model.core.parameters())
    out = []
    for ctx in (mode.training_mode, contextlib.nullcontext):
        with ctx():
            loss, _ = model.train_loss(batch, draws=draws)
            out.append((loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)))
    (loss_in, grads_in), (loss_out, grads_out) = out
    torch.testing.assert_close(loss_out, loss_in, rtol=1e-5, atol=1e-7)
    assert sum(g is not None for g in grads_in) > 0
    for a, b in zip(grads_in, grads_out):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("grad_enabled,requires_grad", [(True, True), (True, False),
                                                        (False, True)])
def test_require_no_grad_refuses_only_an_input_that_wants_a_gradient(grad_enabled,
                                                                      requires_grad):
    x = torch.zeros(4, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_enabled):
        if grad_enabled and requires_grad:
            with pytest.raises(RuntimeError, match="training_mode"):
                kernels.require_no_grad("some_fwd", torch.zeros(2), x)
        else:
            kernels.require_no_grad("some_fwd", torch.zeros(2), x)


@pytest.mark.parametrize("fn", [geglu.ln_proj_fwd, geglu.ln_geglu_fwd, gnproj.gn_proj_fwd,
                                attention.attention_fwd, attention.attention_q8,
                                split3.split3_fwd], ids=lambda f: f.__name__)
def test_every_forward_only_wrapper_checks_for_gradients_before_its_launch(fn):
    """The kernels' CUDA branch cannot run here, so this reads the source:
    the guard comes before the library call that launches the kernel."""
    src = inspect.getsource(fn)
    assert f'kernels.require_no_grad("{fn.__name__}"' in src
    assert src.index("require_no_grad") < src.index("library()")


def test_route_launches_of_the_train_cli_path():
    """What the training CLI's validation launches at 256² on
    configs/train_ip.yaml: one batch-64 val-loss forward (no decode; at
    latents 32² the self-attention kernel takes the five S = 1024 sites,
    split3 the S = 1024 and 256 ones, the LN kernels all 16 sites, gn_proj
    all but the 4² mid block) and a 4-level grid of 10 steps with its
    decode, whose LN kernels skip the 8² and 4² levels (M % 512)."""
    ip = core_config_from(load_config(ROOT / "configs" / "train_ip.yaml"))
    vae = VAEConfig()
    assert route_launches(ip, vae, 64, 256, 1, decode=False) == {
        "attention": 5, "split3": 10, "ln_proj": 32, "ln_geglu": 16, "gn_proj": 15}
    assert route_launches(ip, vae, 4, 256, 10) == {
        "attention": 51, "split3": 100, "ln_proj": 200, "ln_geglu": 100, "gn_proj": 150}
    assert route_launches(ip, vae, 4, 256, 10, decode=False)["attention"] == 50
