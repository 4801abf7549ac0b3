"""The W8A8 int8 UNet (`UNetConfig.quant="int8"`) in the port against
psd_tpu, on the CPU, fp32.

`qdense` against psd_tpu's: the bf16-style dot below K = 512, and from it
on the same int8 operands and int32 accumulators (equal) and outputs within
1e-6 relative. The UNet against psd_tpu's int8 UNet on the same parameters
(the port's seeded init carried into psd_tpu's layout): the tiny config (32
and 64 channels: the resblocks' "unet" conv gate at ≤ 32², every projection
below K = 512) and a config with one stage at 512 channels and 8 heads
(`qdense`'s int8 branch in the attention projections, both feed-forward
projections and proj_in / proj_out).

Two independent fp32 implementations sum in other orders, so the inputs of
an activation quantization differ by ~3e-7 relative, and now and then one
lands on the other side of a rounding boundary: one int8 code moves by one
step, and the chain of quantizations after it amplifies that (one code
flipped in the 10th of 16 convs of the tiny int8 UNet moves its eps by 7e-3
relative L2; the 512-channel UNet's by 2e-2). So the UNet is compared with
psd_tpu's activation codes and scales handed to the port at each
quantization (`on_psd_tpu_codes`): each of the port's own codes is counted
against psd_tpu's, and the eps is held to 1e-3 relative L2 (it reads ~1e-7).
The int8 UNet also tracks the unquantized one within psd_tpu's own band
(cos > 0.999, rel < 5e-2; psd_tpu/tests/test_quant.py:88-117).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psd_tpu.ops.quant as jquant
from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import load_flax_, state_dict_from_flax, torch_key
from psd_tpu_torch.core.mode import training_mode
from psd_tpu_torch.models import layers
from psd_tpu_torch.models.init import flax_init_
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.ops import quant
from psd_tpu_torch.testing import tiny_dadd

from tests.torch_cli_parity import few_threads
from tests.torch_parity import as_flax, on_psd_tpu_codes, record_psd_tpu

# tiny_dadd's routing (the UNet's split3 with 4-token banks) and gates of
# tests/test_torch_modules.py
SPLIT3 = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4)
GATES = dict(gate_init_anatomy=(0.9, 0.1), gate_init_disease=(0.1, 0.9))
WIDE = dict(block_out_channels=(32, 512), num_heads=8)
CONFIGS = {"tiny": dict(SPLIT3, **GATES), "wide512": dict(SPLIT3, **GATES, **WIDE)}
# the eps against psd_tpu's on psd_tpu's activation codes (relative L2)
UNET_INT8_BAND = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite's six workers share a few cores (tests/torch_cli_parity.py)
    with few_threads():
        yield


# ---- qdense ---------------------------------------------------------------------------
QDENSE = {"rank2_shallow": ((64, 320), 256), "rank3_shallow": ((4, 16, 448), 320),
          "rank2_deep": ((64, 512), 256), "rank3_deep": ((4, 16, 1280), 640),
          "few_rows": ((3, 640), 128), "outlier_row": ((8, 640), 64)}


@pytest.mark.parametrize("case", list(QDENSE))
def test_qdense_matches_psd_tpu(case):
    shape, N = QDENSE[case]
    K = shape[-1]
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "outlier_row":
        x[0] *= 1000.0
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)  # psd_tpu's (K, N)
    b = rng.standard_normal(N).astype(np.float32)
    ref = np.asarray(jquant.qdense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   out_dtype=jnp.float32))
    wt = torch.from_numpy(w.T.copy())
    wq, sw = quant.quant_cols(wt, axis=0)
    out = quant.qdense(torch.from_numpy(x), wt, wq, sw.reshape(-1), torch.from_numpy(b),
                       out_dtype=torch.float32).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    if quant.quant_worthwhile(K):
        xq_j, sx_j = jquant.quant_rows(jnp.asarray(x))
        wq_j, sw_j = jquant.quant_cols(jnp.asarray(w), axis=-1)
        acc_j = jax.lax.dot_general(xq_j, wq_j, (((x.ndim - 1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
        xq, sx = quant.quant_rows(torch.from_numpy(x).reshape(-1, K))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j).reshape(-1, K))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j).reshape(-1, 1))
        np.testing.assert_array_equal(wq.numpy().T, np.asarray(wq_j))
        np.testing.assert_array_equal(quant.int_mm(xq, wq).numpy(),
                                      np.asarray(acc_j).reshape(-1, N))
    if case == "outlier_row":  # per-row scales: the other rows keep their resolution
        assert _rel(out[1:], x[1:] @ w + b) < 1e-2


def test_qdense_needs_the_int8_weights_from_k_512():
    with pytest.raises(ValueError, match="int8 weights"):
        quant.qdense(torch.zeros(4, 512), torch.zeros(8, 512))


@pytest.mark.parametrize("M", [1, 5, 16, 17, 40])
def test_int_mm_is_exact_at_any_row_count(M):
    """Below 17 rows (the card's _int_mm refuses them) the rows are padded
    with zeros and sliced off: the same exact product."""
    rng = np.random.default_rng(M)
    a = rng.integers(-127, 128, (M, 64), dtype=np.int8)
    b = rng.integers(-127, 128, (24, 64), dtype=np.int8)
    out = quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32 and out.shape == (M, 24)
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# ---- the resblock's "unet" gate ------------------------------------------------------
@pytest.mark.parametrize("size", [32, 64])
def test_unet_gate_resblock_matches_psd_tpu(size):
    """The UNet's int8 gate takes H, W ≤ 32 (at 64² the block stays bf16):
    the same decision and, on psd_tpu's activation codes, the same output
    (fp32 rounding, atol 1e-5)."""
    from psd_tpu.models.layers import ResnetBlock2D as JaxResnetBlock2D
    from psd_tpu_torch.models.layers import ResnetBlock2D

    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 64)).astype(np.float32)
    temb = rng.standard_normal((2, 128)).astype(np.float32)
    jm = JaxResnetBlock2D(96, quant="int8", quant_gate="unet", dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x, temb))
    tm = load_flax_(ResnetBlock2D(64, 96, 128, dtype=torch.float32, quant="int8",
                                  quant_gate="unet"), params)
    assert tm._q_conv_ok(torch.from_numpy(x)) == (size <= 32)
    if size > 32:
        with torch.no_grad():
            out = tm(torch.from_numpy(x), torch.from_numpy(temb)).numpy()
        np.testing.assert_allclose(out, np.asarray(jm.apply(params, x, temb)), rtol=1e-5,
                                   atol=1e-5)
        return
    ref, seen = record_psd_tpu(jm.apply, params, x, temb)
    out, differ, codes = on_psd_tpu_codes(
        seen, lambda: tm(torch.from_numpy(x), torch.from_numpy(temb)))
    assert len(seen) == 2 and differ <= 1e-4 * codes
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ---- the UNet ---------------------------------------------------------------------------
def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    return x, t, ctx


@pytest.fixture(scope="module")
def psd_tpu_int8():
    """Per config: the core's parameters (the port's seeded tiny DADD in
    psd_tpu's layout), psd_tpu's int8 UNet eps on `_inputs()` and its
    activation codes, recorded once."""
    x, t, ctx = _inputs()
    out = {}
    for name, kw in CONFIGS.items():
        unet_kw = {k: v for k, v in kw.items() if k not in SPLIT3}
        jmodel = jax_tiny_dadd(**unet_kw, quant="int8")
        core = as_flax(tiny_dadd(seed=2, **unet_kw).core, lambda k: jmodel.init_core(k, 32))
        jm = JaxUNet(jax_tiny_unet(**kw, quant="int8"))
        unet = {"params": core["params"]["unet"]}
        ref, seen = record_psd_tpu(lambda p: jm.apply(p, x, t, ctx, jnp.float32(0.5)), unet)
        out[name] = core, ref, seen
    return out


def _eps(unet):
    x, t, ctx = _inputs()
    return lambda: unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 0.5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_unet_matches_psd_tpu(psd_tpu_int8, name):
    core, ref, seen = psd_tpu_int8[name]
    tm = load_flax_(UNet2DCondition(tiny_unet_config(**CONFIGS[name], quant="int8")),
                    {"params": core["params"]["unet"]})
    if name == "wide512":  # qdense's int8 branch at every projection of the 512 stage
        assert {n for m in tm.modules() for n in getattr(m, "int8_sites", ())} >= {
            "to_q", "to_k", "to_v", "to_out_0", "net_0_proj", "net_2", "proj_in", "proj_out"}
    out, differ, codes = on_psd_tpu_codes(seen, _eps(tm))
    with torch.no_grad():
        free = _eps(tm)().numpy()
    rel = _rel(out, ref)
    print(f"{name}: eps rel L2 {rel:.3e} on psd_tpu's codes; {differ} of {codes} int8 codes "
          f"differ; on the port's own codes rel L2 {_rel(free, ref):.3e}")
    assert np.isfinite(out).all() and rel <= UNET_INT8_BAND
    assert differ <= 1e-4 * codes


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_unet_tracks_the_unquantized_unet(psd_tpu_int8, name):
    """psd_tpu's quality gate for the int8 UNet on the port: the same
    parameters with quant "none" and "int8", 48 context tokens (16 a bank)."""
    x, t, _ = _inputs(1)
    ctx = np.random.default_rng(3).standard_normal((2, 48, 32)).astype(np.float32)
    kw = dict(CONFIGS[name], num_aoe_tokens=16, num_image_tokens=16, num_delta_tokens=16)
    unet = {"params": psd_tpu_int8[name][0]["params"]["unet"]}
    plain = load_flax_(UNet2DCondition(tiny_unet_config(**kw)), unet)
    q8 = load_flax_(UNet2DCondition(tiny_unet_config(**kw, quant="int8")), unet)
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 0.5)
        ref, out = plain(*args).double().numpy(), q8(*args).double().numpy()
    cos = float((out * ref).sum() / (np.linalg.norm(out) * np.linalg.norm(ref)))
    assert cos > 0.999, cos
    assert 1e-3 < _rel(out, ref) < 5e-2  # int8 moved it, within the band


# ---- the model's int8 weights ---------------------------------------------------------
def _wide_dadd(**kw):
    return tiny_dadd(seed=None, **GATES, **WIDE, **kw)


def test_load_flax_computes_the_int8_weights_from_the_fp32_arrays(psd_tpu_int8):
    """A bf16 serving model (`load_flax`) holds the int8 weights psd_tpu's
    quant_cols gives for the fp32 arrays, bit for bit, at every int8 site
    (Linear, 1×1 and 3×3 convs), not those of its bf16 copy; and an fp32
    model loaded so gives psd_tpu's int8 eps (on psd_tpu's codes)."""
    from psd_tpu_torch.core.config import Config
    from psd_tpu_torch.diffusion.dadd import DADD

    core, ref, seen = psd_tpu_int8["wide512"]
    port = _wide_dadd(quant="int8")
    core_cfg = replace(port.core_cfg, unet=replace(port.core_cfg.unet, dtype=torch.bfloat16))
    bf16 = DADD(Config(), core_cfg=core_cfg, vae_cfg=port.vae_cfg, clip_cfg=port.clip_cfg,
                device="cpu", seed=None)
    bf16.load_flax(core)
    sd = state_dict_from_flax(core, bf16.core)
    sites, moved = 0, 0
    for prefix, m in bf16.core.named_modules():
        for name in getattr(m, "int8_sites", ()):
            sites += 1
            w = sd[f"{prefix}.{name}.weight"].numpy()
            w_n = w.reshape(w.shape[0], -1).T  # output channel last, as psd_tpu's kernels
            wq_j, sw_j = jquant.quant_cols(jnp.asarray(w_n), axis=-1)
            wq = getattr(m, f"{name}_wq").reshape(w.shape[0], -1).numpy()
            np.testing.assert_array_equal(wq, np.asarray(wq_j).T)
            np.testing.assert_array_equal(getattr(m, f"{name}_sw").numpy(),
                                          np.asarray(sw_j).reshape(-1))
            assert getattr(m, name).weight.dtype == torch.bfloat16
            wq_b, _ = quant.quant_cols(getattr(m, name).weight.float().reshape(wq.shape), axis=0)
            moved += int((wq_b.numpy() != wq).any())
    assert sites and moved  # the bf16 copy quantizes to other codes

    port.load_flax(core)
    assert all(m.int8_ready for m in port.core.modules() if getattr(m, "int8_sites", ()))
    out, differ, codes = on_psd_tpu_codes(seen, _eps(port.core.unet))
    assert _rel(out, ref) <= UNET_INT8_BAND and differ <= 1e-4 * codes


def test_bridge_stays_strict_both_ways_on_an_int8_model(psd_tpu_int8):
    """The int8 weights are non-persistent buffers: the bridge and the
    checkpoints see psd_tpu's tree, leaf for leaf, and refuse stray and
    missing leaves as on the plain model."""
    core = psd_tpu_int8["wide512"][0]
    port = _wide_dadd(quant="int8")
    assert port.core.state_dict().keys() == _wide_dadd().core.state_dict().keys()
    assert any(n.endswith("_wq") for n, _ in port.core.named_buffers())
    leaves = []

    def walk(tree, prefix=()):
        for k, v in tree.items():
            walk(v, prefix + (k,)) if isinstance(v, dict) else leaves.append((prefix + (k,), v))

    walk(core["params"])
    sd = state_dict_from_flax(core, port.core)
    assert len(sd) == len(leaves) == len(port.core.state_dict())
    for path, leaf in leaves:
        key, perm = torch_key(path, np.ndim(leaf))
        assert tuple(sd[key].shape) == (np.shape(leaf) if perm is None else
                                        tuple(np.shape(leaf)[p] for p in perm))
    with pytest.raises(KeyError, match="no such port parameter"):
        state_dict_from_flax({"params": dict(core["params"], extra={"kernel": np.zeros((2, 2))})},
                             port.core)
    with pytest.raises(KeyError, match="not filled"):
        state_dict_from_flax({"params": {k: v for k, v in core["params"].items()
                                         if k != "feature_purifier"}}, port.core)


def test_cast_weights_without_their_int8_weights_raise():
    unet = UNet2DCondition(tiny_unet_config(**CONFIGS["wide512"], quant="int8"))
    layers.store_weights_in_(unet, torch.bfloat16)
    x, t, ctx = _inputs()
    with pytest.raises(ValueError, match="quantize_int8_weights_"), torch.no_grad():
        unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 0.5)


def test_training_mode_loss_is_the_exact_paths():
    """Under training_mode() an int8 model computes the exact path: its loss
    equals the plain model's bit for bit; outside it the loss moves (a
    training model quantizes its fp32 masters at each inference use)."""
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
             "labels": np.array([0.0, 3.0], np.float32),
             "clip_feats": rng.standard_normal((2, 17, 32)).astype(np.float32)}
    plain = tiny_dadd(for_training=True, seed=1)
    q8 = tiny_dadd(for_training=True, seed=None, quant="int8")
    q8.core.load_state_dict(plain.core.state_dict())
    draws = plain.sample_draws((2, 16, 16, 4), torch.Generator().manual_seed(0))
    losses = {}
    for name, model in (("plain", plain), ("int8", q8)):
        with torch.no_grad():
            with training_mode():
                losses[name, "train"] = model.train_loss(batch, draws=draws)[0]
            losses[name, "serve"] = model.train_loss(batch, draws=draws)[0]
    assert torch.equal(losses["plain", "train"], losses["int8", "train"])
    assert not torch.equal(losses["plain", "serve"], losses["int8", "serve"])


# ---- the routes -------------------------------------------------------------------------
LEVERS = {"exact": {}, "int8": dict(quant="int8"),
          "tome_branch": dict(tome_ratio=0.5, tome_min_tokens=1024),
          "tome_block": dict(tome_ratio=0.5, tome_min_tokens=1024, tome_mode="block"),
          "tome_mlp_cross": dict(tome_ratio=0.5, tome_min_tokens=1024, tome_mlp=True,
                                 tome_cross=True)}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_route_launches_count_the_sites_the_model_routes(monkeypatch, lever):
    """route_launches, which chip_smoke.py holds every program's launches
    to, counts what the model's sites route to the kernels under each
    lever: a UNet whose routes admit the kernels (64 and 512 channels, 8
    heads, 32² latents; ToMe merges its 1024-token sites to 512), its
    wrappers counted on the CPU (where each runs its plain version)."""
    from psd_tpu_torch.diffusion.dadd import DADDCoreConfig
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.ops import attention
    from psd_tpu_torch.testing import route_launches

    seen = {k: 0 for k in ("attention", "split3", "ln_proj", "ln_geglu", "gn_proj")}

    def counted(module, attr, name):
        fn = getattr(module, attr)

        def call(*a, **k):
            seen[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, attr, call)

    counted(attention, "attention_fwd", "attention")
    counted(layers, "split3_attention", "split3")
    counted(layers, "ln_proj_fwd", "ln_proj")
    counted(layers, "ln_geglu_fwd", "ln_geglu")
    counted(layers, "gn_proj_fwd", "gn_proj")
    ucfg = tiny_unet_config(**SPLIT3, block_out_channels=(64, 512), num_heads=8,
                            **LEVERS[lever])
    unet = UNet2DCondition(ucfg)  # torch's default init: only the routes are read
    rng = np.random.default_rng(0)
    with torch.no_grad():
        unet(torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32)),
             torch.tensor([300]), torch.from_numpy(rng.standard_normal((1, 12, 32),
                                                                      ).astype(np.float32)), 1.0)
    core_cfg = DADDCoreConfig(unet=ucfg, num_aoe_tokens=4, num_image_tokens=4)
    want = route_launches(core_cfg, VAEConfig(), 1, 256, 1, decode=False)
    assert seen == want
    assert want["attention"] and want["split3"]
    assert (want["gn_proj"] == 0) == (lever == "int8")
