"""ToMe token merging in the port against psd_tpu, on the CPU.

`psd_tpu_torch/ops/tome.py` against `psd_tpu/ops/tome.py`: the spec's
counts, the static region indices, and build_merge / merge / unmerge for
m ∈ {1, 2, 3} (the merge masks and the gather maps equal exactly, the
values within 1e-6 abs in fp32, duplicate tokens, whose similarities tie,
included). Then the tiny UNet with ToMe (16² latents, `tome_min_tokens=256`
so that its 16×16 sites merge) in branch and block mode and with
`tome_mlp` / `tome_cross`, against psd_tpu's UNet2DCondition on the same
parameters (the port's seeded init carried into psd_tpu's layout, no JAX
init run): rtol 2e-4 / atol 2e-5, the whole-network band of
tests/test_torch_modules.py; a tiny `DADD.generate` with ToMe within the
generate tests' atol 1e-4 on images in [0, 1]; the pipelines' `build_model`
and the CLI flags; and training mode, where ToMe is off.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.ops import tome as jtome
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import load_flax_
from psd_tpu_torch.core.mode import training_mode
from psd_tpu_torch.models.init import flax_init_
from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from psd_tpu_torch.ops import tome
from psd_tpu_torch.testing import tiny_dadd

from tests.torch_cli_parity import few_threads
from tests.torch_parity import as_flax

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
UNET_KW = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4,
               gate_init_anatomy=(0.9, 0.1), gate_init_disease=(0.1, 0.9))
# the tiny UNet's 16×16 sites (its level 0 at 16² latents) merge
TINY_TOME = dict(tome_ratio=0.5, tome_min_tokens=256)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite's six workers share a few cores (tests/torch_cli_parity.py)
    with few_threads():
        yield


# ---- the functions ------------------------------------------------------------------
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.2, 0.25, 0.4, 0.5, 0.6, 0.75, 0.9, 1.0])
def test_spec_counts_match_psd_tpu(ratio):
    for min_tokens in (0, 256, 4096):
        t = tome.ToMeSpec(ratio=ratio, min_tokens=min_tokens)
        j = jtome.ToMeSpec(ratio=ratio, min_tokens=min_tokens)
        for n in (64, 256, 1024, 4096, 16384):
            assert t.r_count(n) == j.r_count(n), (ratio, min_tokens, n)
            assert t.active(n) == j.active(n)
            assert t.merged_tokens(n) == n - j.r_count(n)


@pytest.mark.parametrize("H,W", [(2, 2), (4, 6), (8, 8), (64, 64)])
def test_region_indices_match_psd_tpu(H, W):
    for a, b in zip(tome._region_indices(H, W), jtome._region_indices(H, W)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _tokens(seed, B, H, W, C, duplicate: bool):
    x = np.random.default_rng(seed).standard_normal((B, H * W, C)).astype(np.float32)
    if duplicate:
        # every region's three src tokens copies of one vector (their
        # similarities to dst tie), and in half the regions of the dst too
        g = x.reshape(B, H // 2, 2, W // 2, 2, C)
        g[:, :, 0, :, 1] = g[:, :, 1, :, 0] = g[:, :, 1, :, 1]
        g[:, ::2, 0, :, 0] = g[:, ::2, 1, :, 1]
        x = g.reshape(B, H * W, C)
    return x


@pytest.mark.parametrize("duplicate", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_merge_and_unmerge_match_psd_tpu(m, duplicate):
    """The merge mask and the gather map equal psd_tpu's exactly; merge,
    unmerge and merged_call within 1e-6 abs (fp32)."""
    B, H, W, C = 2, 8, 12, 16
    x = _tokens(m, B, H, W, C, duplicate)
    r = m * (H * W // 4)
    mj = jtome.build_merge(jnp.asarray(x), H, W, r)
    mt = tome.build_merge(torch.from_numpy(x), H, W, r)
    np.testing.assert_array_equal(mt.dst_idx.numpy(), np.asarray(mj[0]))
    np.testing.assert_array_equal(mt.src_idx.numpy(), np.asarray(mj[1]))
    np.testing.assert_array_equal(mt.merge_mask.numpy(), np.asarray(mj[2]))
    np.testing.assert_array_equal(mt.gather_map.numpy(), np.asarray(mj[3]))
    assert mt.m == mj[4] == m
    merged = tome.merge(torch.from_numpy(x), mt).numpy()
    assert merged.shape == (B, H * W - r, C)
    np.testing.assert_allclose(merged, np.asarray(jtome.merge(jnp.asarray(x), mj)), rtol=0,
                               atol=1e-6)
    y = np.tanh(merged)
    np.testing.assert_allclose(tome.unmerge(torch.from_numpy(y), mt).numpy(),
                               np.asarray(jtome.unmerge(jnp.asarray(y), mj)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tome.merged_call(torch.sin, torch.from_numpy(x), mt).numpy(),
        np.asarray(jtome.merged_call(jnp.sin, jnp.asarray(x), mj)), rtol=0, atol=1e-6)


def test_merge_of_constant_regions_is_lossless():
    """Every 2×2 region constant: merge then unmerge gives the input back
    at every m (psd_tpu's tests/test_tome.py invariant)."""
    base = np.random.default_rng(1).standard_normal((2, 4, 4, 8)).astype(np.float32)
    x = torch.from_numpy(np.repeat(np.repeat(base, 2, 1), 2, 2).reshape(2, 64, 8))
    for m in (1, 2, 3):
        mi = tome.build_merge(x, 8, 8, m * 16)
        torch.testing.assert_close(tome.unmerge(tome.merge(x, mi), mi), x)


@pytest.mark.parametrize("H,W,r", [(7, 8, 14), (8, 8, 15), (8, 8, 64)],
                         ids=["odd_grid", "not_a_quarter", "m4"])
def test_build_merge_refuses_what_psd_tpu_asserts(H, W, r):
    x = torch.zeros(1, H * W, 4)
    with pytest.raises(ValueError):
        tome.build_merge(x, H, W, r)


# ---- the tiny UNet --------------------------------------------------------------------
CASES = {
    "branch": dict(tome_mode="branch"),
    "block": dict(tome_mode="block"),
    "branch_mlp_cross": dict(tome_mode="branch", tome_mlp=True, tome_cross=True),
    "block_quarter": dict(tome_mode="block", tome_ratio=0.25),
    "branch_three_quarters": dict(tome_mode="branch", tome_ratio=0.75, tome_mlp=True),
}


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    port = flax_init_(UNet2DCondition(tiny_unet_config(**UNET_KW)),
                      torch.Generator().manual_seed(2))
    params = as_flax(port, JaxUNet(jax_tiny_unet(**UNET_KW)).init, x, t, ctx, 0.0)
    return params, x, t, ctx


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_unet_with_tome_matches_psd_tpu(unet_inputs, case):
    params, x, t, ctx = unet_inputs
    kw = dict(UNET_KW, **dict(TINY_TOME, **CASES[case]))
    jm = JaxUNet(jax_tiny_unet(**kw))
    ref = np.asarray(jm.apply(params, x, t, ctx, jnp.float32(1.3)))
    tm = load_flax_(UNet2DCondition(tiny_unet_config(**kw)), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 1.3).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # and ToMe changed the eps: the sites did merge
    plain = np.asarray(JaxUNet(jax_tiny_unet(**UNET_KW)).apply(params, x, t, ctx,
                                                               jnp.float32(1.3)))
    assert np.abs(plain - ref).max() > 1e-3


# ---- generate ---------------------------------------------------------------------
@pytest.mark.parametrize("tome_mode", ["branch", "block"])
def test_generate_with_tome_matches_psd_tpu(tome_mode):
    """tiny DADD at 32² (16² latents), 4 DDIM steps, steer 1.0, the same
    parameters and initial latents: atol 1e-4 on images in [0, 1], as
    tests/test_torch_generate.py."""
    kw = dict(TINY_TOME, tome_mode=tome_mode)
    model = jax_tiny_dadd(**kw)
    seeded = tiny_dadd(seed=0)
    core = as_flax(seeded.core, lambda k: model.init_core(k, 32))
    vae = as_flax(seeded.vae, model.vae.init, jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(2))
    port = tiny_dadd(seed=None, **kw).load_flax(core, vae)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 17, 32)).astype(np.float32)
    tgt, src = np.array([3.0, 0.5], np.float32), np.array([0.0, 2.0], np.float32)
    cond = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                        jnp.asarray(feats))
    key = jax.random.PRNGKey(11)
    ref = np.asarray(model.generate(core, vae, cond, key, image_size=32, sampling_steps=4,
                                    steer_scale=1.0))
    x0 = np.tile(np.asarray(jax.random.normal(key, (1, 16, 16, 4), jnp.float32)), (2, 1, 1, 1))
    out = port.generate(port.prepare_inference_cond(tgt, src, feats),
                        x0=torch.from_numpy(x0), image_size=32, sampling_steps=4,
                        steer_scale=1.0).numpy()
    assert out.shape == (2, 32, 32, 3) and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# ---- the pipelines ------------------------------------------------------------------
@pytest.mark.parametrize("tome_mode", ["branch", "block"])
def test_build_model_carries_tome_and_the_tiny_config_ignores_it(tome_mode):
    from psd_tpu.pipelines.common import build_model as jax_build_model
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.pipelines.common import build_model

    ip = build_model(load_config(ROOT / "configs" / "train_ip.yaml"), tome_ratio=0.5,
                     tome_mode=tome_mode, device="meta")
    u = ip.core_cfg.unet
    assert (u.tome_ratio, u.tome_mode, u.tome_min_tokens) == (0.5, tome_mode, 4096)
    blocks = [m for m in ip.core.modules() if hasattr(m, "tome")]
    assert blocks and all(b.tome == u.tome_spec for b in blocks)
    tiny = build_model(load_config(ROOT / "configs" / "tiny_smoke.yaml"), tome_ratio=0.5,
                       tome_mode=tome_mode, device="cpu")
    from psd_tpu.core.config import load_config as jax_load_config

    jtiny = jax_build_model(jax_load_config(ROOT / "configs" / "tiny_smoke.yaml"),
                            tome_ratio=0.5, tome_mode=tome_mode)
    assert tiny.core_cfg.unet.tome_ratio == jtiny.core_cfg.unet.tome_ratio == 0.0


def test_infer_cli_takes_the_tome_flags(tmp_path):
    """`--tome-ratio 0.5 --tome-mode block` on the tiny config runs and, as
    in psd_tpu, changes nothing there: the images equal the run without the
    flags bit for bit (tests/test_torch_infer.py holds that run to psd_tpu's)."""
    from PIL import Image

    from psd_tpu_torch.pipelines import infer

    png = tmp_path / "s.png"
    Image.fromarray((np.random.default_rng(0).random((40, 40, 3)) * 255).astype(np.uint8)).save(
        png)

    def run(name, *extra):
        return infer.main(["--config", str(ROOT / "configs" / "tiny_smoke.yaml"),
                           "--structure-image", str(png), "--mes-steps", "2",
                           "--sampling-steps", "2", "--image-size", "32", "--output-dir",
                           str(tmp_path / name), "--device", "cpu", *extra])

    a = run("tome", "--tome-ratio", "0.5", "--tome-mode", "block")
    b = run("plain")
    np.testing.assert_array_equal(np.asarray(a["images"]), np.asarray(b["images"]))


# ---- training mode ------------------------------------------------------------------
def test_training_mode_loss_is_the_exact_paths():
    """Under training_mode() a ToMe model computes the exact path: its loss
    equals the plain model's bit for bit; outside it the loss moves."""
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
             "labels": np.array([0.0, 3.0], np.float32),
             "clip_feats": rng.standard_normal((2, 17, 32)).astype(np.float32)}
    plain = tiny_dadd(for_training=True, seed=1)
    merged = tiny_dadd(for_training=True, seed=None, **TINY_TOME)
    merged.core.load_state_dict(plain.core.state_dict())
    draws = plain.sample_draws((2, 16, 16, 4), torch.Generator().manual_seed(0))
    losses = {}
    for name, model in (("plain", plain), ("tome", merged)):
        with torch.no_grad():
            with training_mode():
                losses[name, "train"] = model.train_loss(batch, draws=draws)[0]
            losses[name, "serve"] = model.train_loss(batch, draws=draws)[0]
    assert torch.equal(losses["plain", "train"], losses["tome", "train"])
    assert not torch.equal(losses["plain", "serve"], losses["tome", "serve"])
