"""The turbo serving point on the CPU: the port against psd_tpu.

DPM-Solver++(2M), the UNet phases behind encoder propagation and DeepCache,
the int8 VAE decoder (W8A8 resblock convs) and their composition in
`DADD.generate` and the `GenerationServer`. Parameters are the port's seeded
flax-style init, carried into psd_tpu's tree layout (`jax.eval_shape` of its
init, no JAX init run; leaves the port lacks, the VAE encoder's, are zeros
and unused); inputs come from numpy's default_rng; fp32 on both sides. Tolerances: rtol 2e-4 / atol 2e-5 for whole networks (the UNet
band of tests/test_torch_modules.py), atol 1e-4 on generated images in
[0, 1] (as tests/test_torch_generate.py), tighter where one op is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
from psd_tpu.diffusion.sampler import dpm_sample as jax_dpm
from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.models.vae import AutoencoderKL
from psd_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from psd_tpu.ops.quant import qconv3x3 as jax_qconv3x3
from psd_tpu.ops.quant import quant_cols as jax_quant_cols
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import load_flax_, to_flax_tree, torch_key, vae_decode_tree
from psd_tpu_torch.diffusion.sampler import SamplerConfig, dpm_sample
from psd_tpu_torch.diffusion.schedule import NoiseSchedule
from psd_tpu_torch.models.init import flax_init_
from psd_tpu_torch.models.layers import quantize_int8_weights_
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.models.vae import VAEDecode, tiny_vae_config
from psd_tpu_torch.ops.quant import qconv3x3, quant_cols
from psd_tpu_torch.pipelines.serve import GenerationServer
from psd_tpu_torch.testing import tiny_dadd

RTOL, ATOL = 2e-4, 2e-5
UNET_KW = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4,
               gate_init_anatomy=(0.9, 0.1), gate_init_disease=(0.1, 0.9))
# a VAE whose decoder resblocks all pass the "vae" int8 gate (tiny_vae_config's
# 32/64 channels never do): 256 channels at ≤ 256², then 256→128 and 128→128
GATED_VAE = dict(block_out_channels=(128, 256), layers_per_block=1)
TURBO = dict(sampler="dpm", sampling_steps=7, encoder_stride=5, cache_mode="deep")


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _as_flax(module, init_fn, *args):
    """`module`'s tensors in the layout of psd_tpu's `init_fn(key, *args)`
    tree ({"params": ...}), zeros for leaves the module lacks."""
    like = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    tensors = dict(module.state_dict())
    for path, leaf in _leaves(like["params"]):
        key, perm = torch_key(path, len(leaf.shape))
        if key not in tensors:
            shape = leaf.shape if perm is None else tuple(leaf.shape[i] for i in perm)
            tensors[key] = torch.zeros(shape)
    return {"params": to_flax_tree(tensors, like)}


# ---- qconv3x3 ------------------------------------------------------------------
@pytest.mark.parametrize("C", [256, 128])
def test_qconv3x3_matches_psd_tpu(C):
    """The same int8 operands on both sides (weights and activations
    quantized bit-equal) and the same exact int32 product (nine int8 GEMMs
    here, one int32 conv in psd_tpu): the fp32 epilogue agrees to rounding
    (rtol 1e-5)."""
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, 6, 5, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, 64)) * C ** -0.5).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jax_qconv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    wq, sw = quant_cols(_t(w.transpose(3, 2, 0, 1).copy()), axis=0)
    out = qconv3x3(_t(x), wq, sw.reshape(-1), _t(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ---- UNet phases -----------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = JaxUNet(jax_tiny_unet(**UNET_KW))
    tm = flax_init_(UNet2DCondition(tiny_unet_config(**UNET_KW)), torch.Generator().manual_seed(2))
    params = _as_flax(tm, jm.init, x, t, ctx, 0.0)
    return jm, params, tm, x, t, ctx


def _close(out, ref):
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(out)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("phase", ["encode", "decode", "deep", "shallow"])
def test_unet_phase_matches_psd_tpu(unet_pair, phase):
    """"decode" and "shallow" start from psd_tpu's own "encode"/"deep"
    outputs, handed to both sides; "decode" never reads the sample."""
    jm, params, tm, x, t, ctx = unet_pair
    ds = 1.3

    def jax_run(ph, cached=None, sample=x):
        return jm.apply(params, sample, t, ctx, jnp.float32(ds), phase=ph, cached=cached)

    cached = None
    if phase == "decode":
        cached = jax_run("encode")
    elif phase == "shallow":
        cached = jax_run("deep")[1]
    ref = jax_run(phase, cached, np.zeros((2, 1, 1, 4), np.float32) if phase == "decode" else x)
    t_cached = jax.tree_util.tree_map(_t, jax.device_get(cached))
    if phase == "decode":
        t_cached = (t_cached[0], list(t_cached[1]))
    with torch.no_grad():
        out = tm(None if phase == "decode" else _t(x), _t(t), _t(ctx), ds, phase=phase,
                 cached=t_cached)
    if phase == "encode":
        assert len(out[1]) == len(ref[1]) == 4
        out = (out[0], list(out[1]))
    _close(jax.tree_util.tree_map(lambda a: a.numpy(), out), ref)


def test_unet_phase_names_checked(unet_pair):
    _, _, tm, x, t, ctx = unet_pair
    with pytest.raises(ValueError, match="phase"):
        tm(_t(x), _t(t), _t(ctx), 0.0, phase="middle")
    with pytest.raises(ValueError, match="cached"):
        tm(_t(x), _t(t), _t(ctx), 0.0, phase="shallow")


# ---- DPM-Solver++ -------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 7])
def test_dpm_sample_matches_psd_tpu(steps):
    """A linear eps function: the loop with host fp32 coefficients and the
    scan agree to fp32 rounding (rtol 1e-5)."""
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)

    def eps(x, t, i):
        return 0.3 * x + 0.01 * t[:, None, None, None]

    out_j = np.asarray(jax_dpm(eps, jnp.asarray(x), JaxSchedule(), JaxSamplerConfig(steps)))
    out_t = dpm_sample(eps, _t(x), NoiseSchedule(), SamplerConfig(steps)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


# ---- generate at the turbo point ---------------------------------------------------
@pytest.fixture(scope="module")
def dadd_pair():
    model = jax_tiny_dadd()
    seeded = tiny_dadd(seed=0)
    core = _as_flax(seeded.core, lambda k: model.init_core(k, 32))
    vae = _as_flax(seeded.vae, model.vae.init, jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(2))
    return model, core, vae, tiny_dadd(seed=None).load_flax(core, vae)


def _conds(model, core, port):
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 17, 32)).astype(np.float32)
    tgt, src = np.array([3.0, 0.5], np.float32), np.array([0.0, 2.0], np.float32)
    cond_j = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                          jnp.asarray(feats))
    return cond_j, port.prepare_inference_cond(tgt, src, feats), (tgt, src, feats)


@pytest.mark.parametrize("cache_mode", ["deep", "encoder"])
def test_generate_turbo_matches_psd_tpu(dadd_pair, cache_mode):
    """DPM-Solver++(2M), 7 steps, stride 5 (key steps 0, 5, 6): the TURBO
    composition with DeepCache, and with encoder propagation; the same
    initial latents on both sides."""
    model, core, vae, port = dadd_pair
    cond_j, cond_t, _ = _conds(model, core, port)
    kw = dict(TURBO, cache_mode=cache_mode)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(model.generate(core, vae, cond_j, key, image_size=32, steer_scale=1.0,
                                    **kw))
    x0 = np.tile(np.asarray(jax.random.normal(key, (1, 16, 16, 4), jnp.float32)), (2, 1, 1, 1))
    out = port.generate(cond_t, x0=_t(x0), image_size=32, steer_scale=1.0, **kw).numpy()
    assert out.shape == (2, 32, 32, 3) and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_turbo_counts_full_and_shallow_evaluations(dadd_pair):
    """25 DPM steps at stride 5: 6 full ("deep") and 19 shallow evaluations,
    as chip_smoke.py counts them on the card."""
    _, _, _, port = dadd_pair
    calls = {"eps_deep": 0, "eps_shallow": 0}
    core = port.core
    for name in calls:
        fn = getattr(core, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        setattr(core, name, counted)
    try:
        cond = port.prepare_inference_cond([1.0, 2.0], [0.0, 0.0], np.zeros((2, 17, 32),
                                                                           np.float32))
        port.sample(cond, torch.zeros(2, 4, 4, 4), sampling_steps=25, encoder_stride=5,
                    cache_mode="deep", sampler="dpm")
    finally:
        for name in calls:
            delattr(core, name)
    assert calls == {"eps_deep": 6, "eps_shallow": 19}


def test_cfg_with_stride_raises_on_both_sides(dadd_pair):
    model, core, vae, port = dadd_pair
    cond_j, cond_t, _ = _conds(model, core, port)
    with pytest.raises(ValueError, match="CFG"):
        model.generate(core, vae, cond_j, jax.random.PRNGKey(0), image_size=32,
                       cond_uncond=cond_j, **TURBO)
    with pytest.raises(ValueError, match="CFG"):
        port.generate(cond_t, x0=torch.zeros(2, 16, 16, 4), image_size=32,
                      cond_uncond=cond_t, **TURBO)


def test_server_passes_the_turbo_knobs(dadd_pair):
    """A server at the turbo point returns what generate returns with the
    same knobs and the batch's generator, and not the exact path's images."""
    from psd_tpu_torch.pipelines.serve import SEED_BASE

    _, _, _, port = dadd_pair
    server = GenerationServer(port, image_size=32, max_batch=2, max_wait_s=0.2,
                              steer_scale=1.0, sampling_steps=7, encoder_stride=5,
                              cache_mode="deep", sampler="dpm")
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 17, 32)).astype(np.float32)
    futures = [server.submit(feats[i], float(i + 1), 0.0, seed=3) for i in range(2)]
    images = np.stack([f.result(timeout=300) for f in futures])
    server.close()
    assert not server._worker.is_alive()
    cond = port.prepare_inference_cond([1.0, 2.0], [0.0, 0.0], feats)

    def gen(**kw):
        g = torch.Generator().manual_seed(SEED_BASE + 3)
        return port.generate(cond, generator=g, image_size=32, steer_scale=1.0,
                             shared_noise=False, **kw).numpy()

    np.testing.assert_allclose(images, gen(**TURBO), rtol=0, atol=1e-6)
    assert not np.allclose(images, gen(sampling_steps=7), atol=1e-3)


# ---- the int8 VAE decoder ------------------------------------------------------------
@pytest.fixture(scope="module")
def int8_vae():
    vae = AutoencoderKL(jax_tiny_vae(quant="int8", **GATED_VAE))
    port = flax_init_(VAEDecode(tiny_vae_config(**GATED_VAE)), torch.Generator().manual_seed(1))
    params = _as_flax(port, vae.init, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(2))
    return vae, params


@pytest.mark.parametrize("cin,cout", [(256, 256), (256, 128), (128, 128)])
def test_int8_resblock_matches_psd_tpu(cin, cout):
    """One decoder resblock on the int8 branch, the same input on both
    sides: the quantized operands and the int32 products are bit-equal, so
    the block agrees to fp32 rounding (atol 1e-5), 4 orders below the int8
    effect itself (≈ 6e-2 against the fp32 branch)."""
    from psd_tpu.models.layers import ResnetBlock2D as JaxResnetBlock2D
    from psd_tpu_torch.convert.from_jax import state_dict_from_flax
    from psd_tpu_torch.models.layers import ResnetBlock2D

    x = np.random.default_rng(cin + cout).standard_normal((2, 8, 8, cin)).astype(np.float32)
    jm = JaxResnetBlock2D(cout, use_temb=False, eps=1e-6, quant="int8", quant_gate="vae",
                          dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    ref = np.asarray(jm.apply(params, x))
    tm = ResnetBlock2D(cin, cout, eps=1e-6, dtype=torch.float32, quant="int8", quant_gate="vae")
    sd = state_dict_from_flax(params, tm)
    quantize_int8_weights_(tm, sd)
    tm.load_state_dict(sd)
    assert tm._q_conv_ok(_t(x))
    with torch.no_grad():
        out = tm(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_int8_vae_decode_matches_psd_tpu(int8_vae):
    """The whole int8 decoder (all 6 resblocks on the int8 branch, checked
    on the port's modules). Relative L2 band 2e-2, stated against the int8
    effect (3.1e-2 between psd_tpu's int8 and fp32 decodes here): the blocks
    agree to fp32 rounding (test above), but an ulp of difference upstream
    of an activation quantization can flip one rounding, which moves that
    operand by a whole int8 step, and the next quantizations amplify it.
    psd_tpu's own int8 decode moves by up to 2.0e-2 when its latents move
    by 1e-7 relative; latent seeds 5, 6, 7 read 1.2e-2, 7.5e-3, 1.7e-2."""
    vae, params = int8_vae
    z = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(vae.apply(params, jnp.asarray(z), method=vae.decode))
    port = VAEDecode(tiny_vae_config(quant="int8", **GATED_VAE))
    from psd_tpu_torch.convert.from_jax import state_dict_from_flax

    sd = state_dict_from_flax(vae_decode_tree(params), port)
    quantize_int8_weights_(port, sd)
    port.load_state_dict(sd)
    gated = []
    for m in port.modules():
        if hasattr(m, "_q_conv_ok"):
            orig = m._q_conv_ok
            m._q_conv_ok = lambda x, _o=orig: gated.append(_o(x)) or gated[-1]
    with torch.no_grad():
        out = port(_t(z)).numpy()
    assert len(gated) == 6 and all(gated)
    assert out.shape == (2, 16, 16, 3) and np.isfinite(out).all()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel
    # and the int8 branch did change the decode
    plain = load_flax_(VAEDecode(tiny_vae_config(**GATED_VAE)), vae_decode_tree(params))
    with torch.no_grad():
        assert np.linalg.norm(plain(_t(z)).numpy() - out) / np.linalg.norm(ref) > 1e-2


def _int8_buffers(vae):
    return {n: b for n, b in vae.named_buffers() if n.endswith(("_wq", "_sw"))}


def test_int8_weights_come_from_fp32_values(dadd_pair, int8_vae):
    """A bf16-built model holds the int8 weights that psd_tpu's quant_cols
    gives for the fp32 arrays, bit for bit, after load_flax; and at init,
    those of the fp32 weights of a same-seed fp32 build, not of the bf16
    copy it keeps."""
    from psd_tpu_torch.core.config import Config
    from psd_tpu_torch.diffusion.dadd import DADD

    _, core, _, _ = dadd_pair
    _, params = int8_vae
    cfg = Config()
    core_cfg = tiny_dadd(seed=None).core_cfg

    def build(dtype, seed):
        vcfg = tiny_vae_config(quant="int8", dtype=dtype, **GATED_VAE)
        return DADD(cfg, core_cfg=core_cfg, vae_cfg=vcfg, dtype=dtype, device="cpu", seed=seed)

    bf = build(torch.bfloat16, None)
    bf.load_flax(core, params)
    assert bf.vae.decoder.conv_in.weight.dtype == torch.bfloat16
    bufs = _int8_buffers(bf.vae)
    assert len(bufs) == 24  # 6 resblocks × 2 convs × (weights, scales)
    for name, buf in bufs.items():
        *path, leaf = name.split(".")  # decoder.mid_block.resnets_0.conv1_wq
        node = params["params"]
        for part in path:
            node = node[part]
        wq, sw = jax_quant_cols(jnp.asarray(node[leaf[:5]]["kernel"]), axis=-1)
        want = np.asarray(wq).transpose(3, 2, 0, 1) if name.endswith("_wq") else \
            np.asarray(sw).reshape(-1)
        np.testing.assert_array_equal(buf.numpy(), want, err_msg=name)

    at_init_bf, at_init_f32 = build(torch.bfloat16, 5), build(torch.float32, 5)
    for (n, a), (_, b) in zip(_int8_buffers(at_init_bf.vae).items(),
                              _int8_buffers(at_init_f32.vae).items()):
        assert torch.equal(a, b), n
    w32 = at_init_f32.vae.decoder.mid_block.resnets_0.conv1.weight
    assert torch.equal(quant_cols(w32, axis=0)[0], at_init_bf.vae.decoder.mid_block.resnets_0.conv1_wq)
    wbf = at_init_bf.vae.decoder.mid_block.resnets_0.conv1.weight.float()
    assert not torch.equal(quant_cols(wbf, axis=0)[0], at_init_bf.vae.decoder.mid_block.resnets_0.conv1_wq)


def test_chip_smoke_turbo_is_bench_turbo():
    import bench
    import chip_smoke

    assert chip_smoke.TURBO == bench.TURBO
