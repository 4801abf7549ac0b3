"""The baseline conditioning, the eta sampler and the infer CLI's pieces
against psd_tpu, on the CPU in fp32, with psd_tpu's random-init parameters
bridged into the port and inputs from numpy seeds.

Tolerances: 1e-5 max abs for single modules (fp32 in another summation
order); rtol 2e-4 / atol 2e-5 for the tiny UNet (tests/test_torch_modules.py's
band); atol 1e-4 for images after four sampler steps and the decoder
(tests/test_torch_generate.py's band). The baseline-mode CLI (split2, the
plain ImageProjection, CFG against the negative AOE, eta 0.5, LEACE) runs
against psd_tpu's `infer.main` with psd_tpu's parameters and JAX's draws;
the routing-gates CLI is in tests/test_torch_clip.py.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from psd_tpu.conditioning.leace import apply_leace as jax_apply_leace
from psd_tpu.conditioning.leace import fit_leace as jax_fit_leace
from psd_tpu.conditioning.leace import load_leace as jax_load_leace
from psd_tpu.conditioning.leace import save_leace as jax_save_leace
from psd_tpu.conditioning.ordinal import BasicOrdinalEmbedder as JaxBOE
from psd_tpu.conditioning.projection import ImageProjection as JaxImageProjection
from psd_tpu.diffusion.dadd import DADD as JaxDADD
from psd_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
from psd_tpu.diffusion.sampler import ddim_sample as jax_ddim_sample
from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from psd_tpu.models.layers import Attention as JaxAttention
from psd_tpu.models.layers import CrossAttnMode as JaxMode
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu.utils.image_io import progression_grid as jax_progression_grid
from psd_tpu.utils.image_io import to_uint8 as jax_to_uint8
from psd_tpu_torch.conditioning import BasicOrdinalEmbedder, ImageProjection
from psd_tpu_torch.conditioning.leace import apply_leace, fit_leace, load_leace, save_leace
from psd_tpu_torch.convert.from_jax import load_flax_
from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.diffusion.dadd import core_config_from
from psd_tpu_torch.diffusion.sampler import SamplerConfig, ddim_sample
from psd_tpu_torch.diffusion.schedule import NoiseSchedule
from psd_tpu_torch.models.layers import Attention, CrossAttnMode, Transformer2D
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.models.vae import VAEConfig
from psd_tpu_torch.pipelines import infer
from psd_tpu_torch.testing import route_launches, tiny_dadd
from psd_tpu_torch.utils.image_io import progression_grid, to_uint8
from tests.torch_cli_parity import check_outputs, run_both

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
LABELS = np.array([0.0, 0.4, 1.5, 3.0, -1.0, 5.0], np.float32)


# ---- modules ------------------------------------------------------------------
def test_boe_matches_psd_tpu():
    """Eval, and training with noise (psd_tpu draws it from the rng it is
    given; the port takes those N(0, 1) values)."""
    jm = JaxBOE(num_classes=4, embedding_dim=8)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(LABELS)))
    port = load_flax_(BasicOrdinalEmbedder(4, 8), params)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jm.apply(params, jnp.asarray(LABELS)))
    ref_train = np.asarray(jm.apply(params, jnp.asarray(LABELS), True, rng=rng))
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (6, 8), jnp.float32)))
    with torch.no_grad():
        out = port(torch.from_numpy(LABELS)).numpy()
        out_train = port(torch.from_numpy(LABELS), noise).numpy()
    assert out.shape == (6, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_train, ref_train, rtol=0, atol=1e-6)


def test_image_projection_matches_psd_tpu():
    x = np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32)
    jm = JaxImageProjection(cross_attention_dim=32, num_tokens=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    port = load_flax_(ImageProjection(16, 32, 4), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 4, 32)
    np.testing.assert_allclose(out, np.asarray(jm.apply(params, jnp.asarray(x))), rtol=0,
                               atol=1e-5)


def test_leace_fit_apply_and_npz_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    labels = np.arange(24) % 4
    emb = (rng.standard_normal((24, 4, 8)) + labels[:, None, None] * 0.3).astype(np.float32)
    ours, theirs = fit_leace(emb, labels, rank=2), jax_fit_leace(emb, labels, rank=2)
    for k in ("P_null", "mu", "mayo_dir"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["stats"] == theirs["stats"]
    assert ours["stats"]["dist_after"] < ours["stats"]["dist_before"]
    save_leace(ours, tmp_path / "port.npz")
    jax_save_leace(theirs, tmp_path / "jax.npz")
    from_port, from_jax = jax_load_leace(tmp_path / "port.npz"), load_leace(tmp_path / "jax.npz")
    assert set(from_port) == set(from_jax) == {"P_null", "mu", "mayo_dir", "rank",
                                               "num_tokens", "token_dim"}
    assert (from_jax["rank"], from_jax["num_tokens"], from_jax["token_dim"]) == (2, 4, 8)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    ref = np.asarray(jax_apply_leace(jnp.asarray(x), from_port))
    out = apply_leace(torch.from_numpy(x), from_jax).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_ctx", [8], ids=["neutral"])
def test_split2_attention_site_matches_psd_tpu(n_ctx):
    """psd_tpu's split2 site at the scales of 1 that every config builds."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, n_ctx, 32)).astype(np.float32)
    kw = dict(num_aoe_tokens=4, num_image_tokens=4)
    jm = JaxAttention(num_heads=2, mode=JaxMode("split2", **kw), dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(ctx)))
    port = load_flax_(Attention(32, 2, 32, CrossAttnMode("split2", **kw), dtype=torch.float32),
                      params)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("eta", [0.5, 1.0])
def test_eta_ddim_matches_psd_tpu(eta):
    """psd_tpu's eta-stochastic DDIM with its key; the port with the noise
    JAX draws from that key (one normal per key of split(key, steps))."""
    steps, shape = 6, (2, 4, 4, 4)
    x_init = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    w = np.random.default_rng(9).standard_normal(shape[1:]).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(10)

    def jax_eps(x, t, i):
        return 0.3 * x + jnp.asarray(w) * (t[:, None, None, None] / 1000.0)

    def port_eps(x, t, i):
        return 0.3 * x + torch.from_numpy(w) * (t[:, None, None, None] / 1000.0)

    js = JaxSchedule(1000, 0.00085, 0.012)
    ref = np.asarray(jax_ddim_sample(jax_eps, jnp.asarray(x_init), js,
                                     JaxSamplerConfig(steps, eta=eta), key=key))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                                       for k in jax.random.split(key, steps)]))
    out = ddim_sample(port_eps, torch.from_numpy(x_init), NoiseSchedule(1000, 0.00085, 0.012),
                      SamplerConfig(steps, eta=eta), eta_noise=noise).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="eta_noise"):
        ddim_sample(port_eps, torch.from_numpy(x_init), NoiseSchedule(1000, 0.00085, 0.012),
                    SamplerConfig(steps, eta=eta))


# ---- DADD ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def leace_tokens():
    rng = np.random.default_rng(11)
    labels = np.arange(16) % 4
    emb = (rng.standard_normal((16, 4, 32)) + labels[:, None, None] * 0.2).astype(np.float32)
    return fit_leace(emb, labels)


def _core_pair(name, **kw):
    jm = jax_tiny_dadd(**kw)
    core = jax.device_get(jm.init_core(jax.random.PRNGKey(12), image_size=32))
    port = tiny_dadd(seed=None, **kw)
    load_flax_(port.core, core)
    return name, jm, core, port


@pytest.fixture(scope="module")
def baseline_pair():
    """psd_tpu's tiny baseline DADD (split2, ImageProjection, no purifier)
    and the port's with its core parameters."""
    return _core_pair("baseline", routing=False, purifier=False, plus=False)


@pytest.fixture(scope="module")
def ip_plus_pair():
    return _core_pair("ip_plus", routing=True, purifier=True, plus=True)


@pytest.fixture(params=["baseline", "ip_plus"])
def cond_pair(request):
    return request.getfixturevalue(f"{request.param}_pair")


def test_tiny_split2_unet_eps_matches_psd_tpu(baseline_pair):
    _, jm, core, port = baseline_pair
    assert port.core_cfg.unet.attn_mode == "split2"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    eps = jax.jit(lambda p, *a: jm.core.apply(p, *a, 0.0, method=jm.core.eps))
    ref = np.asarray(eps(core, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        out = port.core.eps(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opts", [dict(), dict(zero_aoe=True), dict(zero_image=True),
                                  dict(leace=True), dict(zero_aoe=True, leace=True)],
                         ids=["plain", "zero_aoe", "zero_image", "leace", "zero_aoe_leace"])
def test_prepare_inference_cond_matches_psd_tpu(cond_pair, leace_tokens, opts):
    """LEACE applies to the projected image tokens, before the purifier."""
    name, jm, core, port = cond_pair
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((3, 17, 32) if name == "ip_plus" else (3, 16)).astype(np.float32)
    tgt, src = np.array([0.0, 1.7, 3.0], np.float32), np.array([1.0, 0.0, 2.5], np.float32)
    kw = dict(opts, image_scale=0.8)
    if opts.get("leace"):
        kw["leace"] = leace_tokens
    ref = np.asarray(jm.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                               jnp.asarray(feats), **kw))
    out = port.prepare_inference_cond(tgt, src, feats, **kw).numpy()
    assert out.shape == ((3, 12, 32) if name == "ip_plus" else (3, 8, 32))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("plus", [True, False], ids=["last_hidden_state", "image_embeds"])
def test_encode_image_clip_matches_psd_tpu(plus):
    jm = jax_tiny_dadd(routing=plus, purifier=plus, plus=plus)
    x = np.random.default_rng(14).standard_normal((2, 32, 32, 3)).astype(np.float32)
    clip = jax.device_get(jm.clip.init(jax.random.PRNGKey(15), jnp.asarray(x)))
    port = tiny_dadd(seed=None, routing=plus, purifier=plus, plus=plus)
    load_flax_(port.clip, clip)
    ref = np.asarray(jm.encode_image_clip(clip, jnp.asarray(x)))
    out = port.encode_image_clip(x)
    assert out.dtype == torch.float32 and out.shape == ((2, 17, 32) if plus else (2, 16))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_clip_tower_built_at_first_use_from_its_seed():
    a, b = tiny_dadd(seed=3), tiny_dadd(seed=3)
    assert a._clip is None
    for (ka, va), (kb, vb) in zip(a.clip.state_dict().items(), b.clip.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.clip is a.clip
    assert not torch.equal(tiny_dadd(seed=4).clip.position_embedding, a.clip.position_embedding)
    # a training model builds the same tower at its first use (the CLI encodes batches)
    t = tiny_dadd(for_training=True, seed=3)
    assert t._clip is None
    t.encode_image_clip(np.zeros((1, 32, 32, 3), np.float32))
    for (ka, va), (kt, vt) in zip(a.clip.state_dict().items(), t.clip.state_dict().items()):
        assert ka == kt and torch.equal(va, vt)
    assert not any(p.requires_grad for p in t.clip.parameters())


def test_boe_conditioning_matches_psd_tpu_and_refuses_what_it_lacks():
    """psd_tpu's BOE has no `negative` and no `ordinal_delta`: CFG's zero_aoe
    and routing gates fail there (AttributeError), and raise here."""
    base = jax_tiny_dadd(routing=False, purifier=False, plus=False)
    jm = JaxDADD(base.cfg, core_cfg=dataclasses.replace(base.core_cfg, embedder_type="boe"),
                 vae_cfg=base.vae_cfg, clip_cfg=base.clip_cfg, dtype=jnp.float32)
    core = jax.device_get(jm.init_core(jax.random.PRNGKey(16), image_size=32))
    port = tiny_dadd(seed=None, routing=False, purifier=False, plus=False, embedder="boe")
    load_flax_(port.core, core)
    feats = np.random.default_rng(17).standard_normal((2, 16)).astype(np.float32)
    tgt, src = np.array([0.5, 2.0], np.float32), np.array([0.0, 3.0], np.float32)
    ref = np.asarray(jm.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                               jnp.asarray(feats)))
    out = port.prepare_inference_cond(tgt, src, feats).numpy()
    assert out.shape == (2, 5, 32)  # one BOE token, four image tokens
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    with pytest.raises(AttributeError):
        jm.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(feats),
                                  zero_aoe=True)
    with pytest.raises(ValueError, match="needs the AOE"):
        port.prepare_inference_cond(tgt, src, feats, zero_aoe=True)
    gated = tiny_dadd(seed=0, embedder="boe")
    with pytest.raises(ValueError, match="needs the AOE"):
        gated.prepare_inference_cond(tgt, src, np.zeros((2, 17, 32), np.float32))


def test_generate_eta_draws_and_graph_key():
    """eta > 0 draws its noise from the generator after x0 (same seed, same
    images); DDIM's eta is a graph knob, DPM-Solver++ ignores it."""
    port = tiny_dadd(seed=18, routing=False, purifier=False, plus=False)
    cond = port.prepare_inference_cond([0.0, 3.0], [0.0, 0.0], np.ones((2, 16), np.float32))

    def run(seed, eta):
        return port.generate(cond, generator=torch.Generator().manual_seed(seed), image_size=32,
                             sampling_steps=3, eta=eta)

    assert torch.equal(run(1, 0.5), run(1, 0.5))
    assert not torch.equal(run(1, 0.5), run(1, 0.0))
    x0 = torch.zeros((2, 16, 16, 4))
    with pytest.raises(ValueError, match="eta_noise"):
        port.generate(cond, x0=x0, image_size=32, sampling_steps=3, eta=0.5)
    knobs = dict(sampling_steps=4, steer_scale=0.0, guidance_scale=1.0, encoder_stride=1,
                 cache_mode="encoder")
    assert port.static_knobs(sampler="ddim", eta=0.5, **knobs) != \
        port.static_knobs(sampler="ddim", **knobs)
    assert port.static_knobs(sampler="dpm", eta=0.5, **knobs) == \
        port.static_knobs(sampler="dpm", **knobs)


def test_route_launches_give_the_measured_counts():
    """At batch 8, 512², the counts chip_smoke.py holds each captured program
    to (measured on the card): exact and turbo. At the CLI's batch 13 the LN
    kernels skip the 8² level (B·S % 128), and baseline mode at 256² with
    CFG (batch 26) has no split3, one self-attention level and no LN kernel
    at 4²."""
    vae = VAEConfig()
    ip = core_config_from(load_config(ROOT / "configs" / "train_ip.yaml"))
    assert route_launches(ip, vae, 8, 512, 50) == chip_smoke.SERVE_LAUNCHES
    assert route_launches(ip, vae, 8, 512, chip_smoke.TURBO_FULL,
                          chip_smoke.TURBO_SHALLOW) == chip_smoke.TURBO_LAUNCHES
    assert route_launches(ip, vae, 13, 512, 50) == {
        "attention": 501, "split3": 750, "ln_proj": 1500, "ln_geglu": 750, "gn_proj": 800}
    base = core_config_from(load_config(ROOT / "configs" / "train.yaml"))
    assert base.unet.attn_mode == "split2"
    assert route_launches(base, vae, 13, 256, 50, cfg_pass=True) == {
        "attention": 251, "split3": 0, "ln_proj": 1500, "ln_geglu": 750, "gn_proj": 750}


@pytest.mark.parametrize("levels,phase", [((32, 64), "full"), ((32, 64), "shallow"),
                                          ((32, 64, 64), "full"), ((32, 64, 64), "shallow")])
def test_transformer_sites_are_the_ones_a_forward_runs(levels, phase):
    """`UNetConfig.transformer_sites`, which `route_launches` reads, names
    the Transformer2Ds a forward runs, in order, at their channels, modes
    and latent sizes (DeepCache's shallow phase included)."""
    u = tiny_unet_config(block_out_channels=levels, attn_mode="split3", num_aoe_tokens=4,
                         num_image_tokens=4, num_delta_tokens=4, gate_init_anatomy=(0.3, 0.7),
                         gate_init_disease=(0.8, 0.2))
    unet, lat = UNet2DCondition(u), 8
    seen = []
    for name, mod in unet.named_children():
        if isinstance(mod, Transformer2D):
            mod.register_forward_pre_hook(
                lambda m, args, name=name: seen.append((name, args[0].shape, m)))
    x = torch.randn(1, lat, lat, 4)
    t, ctx = torch.tensor([10]), torch.randn(1, 12, 32)
    with torch.no_grad():
        cached = unet(x, t, ctx, phase="deep")[1] if phase == "shallow" else None
        seen.clear()
        unet(x, t, ctx, phase=phase, cached=cached)
    sites = u.transformer_sites(shallow=phase == "shallow")
    assert [n for n, _, _ in seen] == [n for n, *_ in sites]
    for (name, shape, mod), (_, level, C, mode) in zip(seen, sites):
        assert tuple(shape[1:]) == (lat >> level, lat >> level, C)
        assert mod.transformer_blocks_0.attn2.mode == mode


# ---- image I/O -----------------------------------------------------------------
def test_image_io_matches_psd_tpu(tmp_path):
    rng = np.random.default_rng(19)
    imgs = rng.uniform(-0.2, 1.2, (3, 24, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(imgs[0]), jax_to_uint8(imgs[0]))
    labels = [0.0, 1.5, 3.0]
    ours = progression_grid(imgs, labels, tmp_path / "a.png", reference=imgs[1])
    theirs = jax_progression_grid(imgs, labels, tmp_path / "b.png", reference=imgs[1])
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(theirs)))


# ---- the CLI -------------------------------------------------------------------
BASELINE_YAML = """\
model:
  tiny: true
  use_routing_gates: false
  use_feature_purifier: false
  use_image_projection_plus: false
  ordinal_embedder: {type: aoe, num_classes: 4, aoe: {delta_scale: 0.05}}
dataset: {batch_size: 4, image_size: 32, num_classes: 4}
diffusion:
  noise_schedule: linear
  beta_start: 0.00085
  beta_end: 0.012
  num_train_timesteps: 100
  sampling_steps: 4
"""


@pytest.fixture
def structure(tmp_path):
    path = tmp_path / "structure.png"
    Image.fromarray(np.random.default_rng(20).integers(0, 256, (40, 56, 3), np.uint8)).save(path)
    return path


def test_cli_baseline_matches_psd_tpu(monkeypatch, tmp_path, structure, leace_tokens):
    """Baseline mode: CLIP image_embeds → ImageProjection → LEACE → split2,
    dual-pass CFG (guidance 2.0) against the negative AOE, eta 0.5."""
    cfg = tmp_path / "baseline.yaml"
    cfg.write_text(BASELINE_YAML)
    save_leace(leace_tokens, tmp_path / "leace.npz")
    argv = ["--config", str(cfg), "--structure-image", str(structure), "--mes-steps", "5",
            "--sampling-steps", "4", "--guidance-scale", "2.0", "--eta", "0.5", "--leace",
            str(tmp_path / "leace.npz"), "--image-size", "32", "--seed", "5", "--dtype", "fp32"]
    ref, out = run_both(monkeypatch, tmp_path, argv, lat=16, steps=4, eta=0.5)
    check_outputs(ref, out, tmp_path)
    assert out["cond"].shape == out["uncond"].shape == (5, 8, 32)


def _tiny_argv(structure, tmp_path, *extra):
    return ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"), "--structure-image",
            str(structure), "--mes-steps", "2", "--sampling-steps", "2", "--image-size", "32",
            "--output-dir", str(tmp_path / "out"), "--device", "cpu", *extra]


@pytest.mark.parametrize("extra,error", [
    (["--checkpoint", "ckpt"], FileNotFoundError),  # a checkpoint that does not exist
    (["--ema"], ValueError),  # EMA weights without a checkpoint to take them from
    (["--tome-ratio", "0.5", "--tome-mode", "global"], SystemExit),  # not a ToMe mode
], ids=["checkpoint", "ema", "tome"])
def test_cli_refuses_what_the_port_lacks(structure, tmp_path, extra, error):
    with pytest.raises(error):
        infer.main(_tiny_argv(structure, tmp_path, *extra))
    assert not (tmp_path / "out").exists()


def test_cli_encoder_stride_with_cfg_exits_as_psd_tpu(structure, tmp_path):
    cfg = tmp_path / "baseline.yaml"
    cfg.write_text(BASELINE_YAML)
    argv = _tiny_argv(structure, tmp_path, "--guidance-scale", "2.0", "--encoder-stride", "2")
    argv[1] = str(cfg)
    with pytest.raises(SystemExit, match="incompatible with dual-pass CFG") as e:
        infer.main(argv)
    assert str(e.value) == (
        "--encoder-stride > 1 is incompatible with dual-pass CFG (baseline mode, "
        "--guidance-scale 2.0): the cached encoder features are conditioning-dependent. "
        "Use --guidance-scale 1 or a routing-gates checkpoint.")


def test_cli_device_never_picks_the_cpu_unasked(monkeypatch, structure, tmp_path):
    """Without a card every --device value but cpu raises, the default
    too; only an explicit cpu runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert infer.build_argparser().parse_args(["--structure-image", "x"]).device == "cuda"
    for value in (None, "auto", "cuda", "cuda:0"):
        argv = _tiny_argv(structure, tmp_path)[:-2]
        if value is not None:
            argv += ["--device", value]
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            infer.main(argv)
    with pytest.raises(ValueError, match="--device"):
        infer.cli_device("meta")
    assert infer.cli_device("cpu") == torch.device("cpu")


def test_cli_profile_writes_a_trace(structure, tmp_path, capsys):
    out = infer.main(_tiny_argv(structure, tmp_path, "--profile"))
    assert (tmp_path / "out" / "trace" / "trace.json").stat().st_size > 0
    text = capsys.readouterr().out
    assert "[profile]" in text and "generate:" in text and "clip_encode:" in text
    assert out["images"].shape == (2, 32, 32, 3)
