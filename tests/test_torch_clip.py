"""The port's CLIP vision tower, its preprocessing and the routing-gates CLI
against psd_tpu, on the CPU.

  * The tiny tower (fp32) with psd_tpu's random-init parameters bridged in:
    `last_hidden_state` and `image_embeds` within max abs 1e-5 (fp32 through
    two encoder layers in another summation order).
  * The ViT-L/14 tree: `jax.eval_shape` of psd_tpu's init against a
    meta-device port tower, through the bridge's key map, strict both ways.
  * The PIL/numpy preprocessing against psd_tpu's `CLIPImageProcessor` call
    on square and non-square images, max abs 1e-6 (the same uint8 resize,
    then float32 arithmetic in the same order).
  * `python -m psd_tpu_torch.pipelines.infer` on configs/tiny_smoke.yaml
    (routing gates, steer 1.0) against psd_tpu's `infer.main`: the same
    parameters (psd_tpu's own, bridged), structure image and draws (JAX's);
    images within atol 1e-4 (fp32 on both sides through four sampler steps
    and the decoder, the band of tests/test_torch_generate.py), the same
    files. The baseline-mode CLI is compared in tests/test_torch_infer.py,
    so the two psd_tpu CLI runs land on different workers.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from psd_tpu.models.clip import CLIPVisionTower as JaxTower
from psd_tpu.models.clip import clip_vit_l14_config as jax_l14
from psd_tpu.models.clip import tiny_clip_config as jax_tiny_clip
from psd_tpu_torch.convert.from_jax import _leaves, load_flax_, torch_key
from psd_tpu_torch.models.clip import CLIPVisionTower, clip_vit_l14_config, tiny_clip_config
from psd_tpu_torch.pipelines import infer
from tests.torch_cli_parity import check_outputs, run_both

ROOT = Path(__file__).resolve().parents[1]


def test_tiny_clip_tower_matches_psd_tpu():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jt = JaxTower(jax_tiny_clip())
    params = jax.device_get(jt.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    port = load_flax_(CLIPVisionTower(tiny_clip_config()), params)
    with torch.no_grad():
        hidden = port.last_hidden_state(torch.from_numpy(x)).numpy()
        embeds = port.image_embeds(torch.from_numpy(x)).numpy()
    ref_h = np.asarray(jt.apply(params, jnp.asarray(x), method=jt.last_hidden_state))
    ref_e = np.asarray(jt.apply(params, jnp.asarray(x), method=jt.image_embeds))
    assert hidden.shape == (2, 17, 32) and embeds.shape == (2, 16)
    np.testing.assert_allclose(hidden, ref_h, rtol=0, atol=1e-5)
    np.testing.assert_allclose(embeds, ref_e, rtol=0, atol=1e-5)


def test_vit_l14_tree_through_the_bridge_without_allocation():
    """Every leaf of psd_tpu's ViT-L/14 tree lands on a port parameter of
    its shape and every port parameter is filled (303,966,208 parameters,
    openai/clip-vit-large-patch14's vision model and projection)."""
    jt = JaxTower(jax_l14())
    tree = jax.eval_shape(lambda k: jt.init(k, jnp.zeros((1, 224, 224, 3))),
                          jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        port = {k: tuple(v.shape) for k, v in
                CLIPVisionTower(clip_vit_l14_config()).state_dict().items()}
    mapped = {}
    for path, leaf in _leaves(tree):
        key, perm = torch_key(path, len(leaf.shape))
        assert key not in mapped, key
        mapped[key] = tuple(leaf.shape) if perm is None else tuple(leaf.shape[p] for p in perm)
    assert mapped == port
    assert port["patch_embedding.weight"] == (1024, 3, 14, 14)
    assert sum(int(np.prod(s)) for s in port.values()) == 303_966_208


@pytest.mark.parametrize("size", [(224, 224), (300, 200), (150, 333), (40, 20), (512, 512)])
def test_clip_preprocess_matches_clip_image_processor(size):
    """psd_tpu's CLIPImageProcessor call (psd_tpu/pipelines/infer.py:79-88)."""
    from transformers import CLIPImageProcessor

    w, h = size
    pil = Image.fromarray(np.random.default_rng(w * h).integers(0, 256, (h, w, 3), np.uint8))
    proc = CLIPImageProcessor(
        do_resize=True, size={"shortest_edge": 224}, do_center_crop=True,
        crop_size={"height": 224, "width": 224}, do_rescale=True, do_normalize=True,
        image_mean=[0.48145466, 0.4578275, 0.40821073],
        image_std=[0.26862954, 0.26130258, 0.27577711])
    ref = np.transpose(proc(images=pil, return_tensors="np").pixel_values[0], (1, 2, 0))
    out = infer.clip_preprocess(pil, 224)
    assert out.shape == (224, 224, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_load_structure_image_matches_psd_tpu(tmp_path):
    from psd_tpu.pipelines.infer import load_structure_image as jax_load

    path = tmp_path / "s.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (90, 70, 3), np.uint8)).save(path)
    clip_j, disp_j = jax_load(path, 48)
    clip_t, disp_t = infer.load_structure_image(path, 48)
    assert clip_t.shape == (1, 224, 224, 3) and disp_t.shape == (48, 48, 3)
    np.testing.assert_array_equal(disp_t, disp_j)
    np.testing.assert_allclose(clip_t, clip_j, rtol=0, atol=1e-6)


# ---- the CLI against psd_tpu's --------------------------------------------------
def test_cli_routing_gates_matches_psd_tpu(monkeypatch, tmp_path, capsys):
    path = tmp_path / "structure.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 48, 3), np.uint8)).save(path)
    argv = ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"), "--structure-image",
            str(path), "--mes-steps", "5", "--sampling-steps", "4", "--steer-scale", "1.0",
            "--source-label", "1.0", "--image-size", "32", "--seed", "3", "--dtype", "fp32"]
    ref, out = run_both(monkeypatch, tmp_path, argv, lat=16, steps=4)
    check_outputs(ref, out, tmp_path)
    assert out["cond"].shape == (5, 12, 32) and out["uncond"] is None
    assert "Generated 5-step progression in" in capsys.readouterr().out
