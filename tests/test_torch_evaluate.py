"""The port's evaluation sweep (`python -m psd_tpu_torch.pipelines.evaluate`)
against psd_tpu's, on the CPU.

  * `collect_jobs` on a synthetic class tree: the same jobs.
  * The CLIP input: `CLIPImageProcessor` handed float images in [0, 1]
    (`do_rescale=False`, psd_tpu's `FeatureBank.clip`) turns each into a
    uint8 image by ·255 and truncation, or, for an image of integer values,
    by a plain cast. The port's bytes (`processor_uint8`) equal
    transformers' byte for byte, and its pixels the processor's within
    1e-6, on generated images, on real ones as the sweep reads them ((the
    loader's [−1, 1] image + 1) / 2 in float32, where the round trip drops
    some levels by one) and on all-0 and all-1 images.
  * The random-backbone refusal.
  * The CLI on configs/tiny_smoke.yaml (steer 2.0, fp32 generation; 2
    images in each of two classes, so 12 jobs in batches of 6 and two
    classes scored: every FID costs two eighs of 2048 × 2048) against psd_tpu's `evaluate.main`:
    the same parameters (the port's seeded tiny model in psd_tpu's layout,
    `tests/torch_cli_parity.py::seeded_load_params`), JAX's draws
    (`fold_in` chained from PRNGKey(seed), anew at each scale), and the same
    Inception and VGG weights (npz drawn from a seed, read by both through
    `--inception-params` / `--vgg-params`; both run them in bf16). The
    metrics.json of each run, with the tolerances stated at the comparison.
  * Two checkpoints in one run (an int8 VAE decoder; the first checkpoint
    ships its own VAE weights, the second does not): the second's images
    equal, bit for bit, those of a run on the second alone; a scale given
    twice gives the same images twice (its draws restart from the seed).
  * Refusals and defaults: `--encoder-stride > 1` with CFG in baseline mode
    exits as psd_tpu's does; `--device` defaults to the card.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers.image_transforms import _rescale_for_pil_conversion, to_pil_image

import psd_tpu.pipelines.evaluate as jeval
from psd_tpu.convert.io import save_params_npz as jax_save_npz
from psd_tpu.data.limuc import LIMUCDataset as JaxLIMUC
from psd_tpu.data.limuc import _get_clip_processor
from psd_tpu.models.inception import InceptionV3Features as JaxInception
from psd_tpu.models.vae import AutoencoderKL as JaxVAE
from psd_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from psd_tpu.models.vgg import VGG16Features as JaxVGG
from psd_tpu_torch.convert.from_jax import VAE_DECODE_KEYS, to_flax_tree
from psd_tpu_torch.convert.npz import save_params_npz
from psd_tpu_torch.data.limuc import LIMUCDataset
from psd_tpu_torch.data.preprocess import clip_preprocess_float, processor_uint8
from psd_tpu_torch.diffusion.dadd import DADD
from psd_tpu_torch.models.vae import tiny_vae_config
from psd_tpu_torch.pipelines import augment, evaluate
from psd_tpu_torch.testing import tiny_dadd
from tests.torch_cli_parity import (TINY, baseline_config, chained_jax_draws, few_threads,
                                    make_class_tree, port_load_params, seeded_load_params)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def test_collect_jobs_matches_psd_tpu(tmp_path):
    data = make_class_tree(tmp_path / "data", counts=(("test", 3),))
    ds = LIMUCDataset(data / "test", image_size=32, return_clip=False)
    jds = JaxLIMUC(data / "test", image_size=32, return_clip=False)
    for per_class in (1, 2, 50):
        got = evaluate.collect_jobs(ds, 4, per_class)
        assert got == jeval.collect_jobs(jds, 4, per_class)
        assert len(got) == 4 * min(per_class, 3) * 3


@pytest.fixture(scope="module")
def real_images(tmp_path_factory):
    data = make_class_tree(tmp_path_factory.mktemp("real"), counts=(("test", 1),), size=(77, 90))
    port = LIMUCDataset(data / "test", image_size=64, return_clip=False)
    ref = JaxLIMUC(data / "test", image_size=64, return_clip=False)
    imgs = [(port.load(i)["image"] + 1.0) / 2.0 for i in range(4)]
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(img, (ref.load(i)["image"] + 1.0) / 2.0)
    return imgs


@pytest.mark.parametrize("kind", ["generated", "real", "zeros", "ones", "small"])
def test_clip_input_matches_clip_image_processor(kind, real_images):
    rng = np.random.default_rng(7)
    img = {"generated": lambda: rng.uniform(0, 1, (48, 48, 3)).astype(np.float32),
           "real": lambda: real_images[1],
           "zeros": lambda: np.zeros((32, 32, 3), np.float32),
           "ones": lambda: np.ones((32, 40, 3), np.float32),
           "small": lambda: rng.uniform(0, 0.01, (30, 30, 3)).astype(np.float32)}[kind]()
    u8, rescaled = processor_uint8(img)
    want_u8 = np.asarray(to_pil_image(img, do_rescale=_rescale_for_pil_conversion(img)))
    np.testing.assert_array_equal(u8, want_u8)
    assert rescaled == (kind not in ("zeros", "ones"))
    proc = _get_clip_processor(size=224)
    want = np.transpose(proc(images=[img], return_tensors="np", do_rescale=False)
                        .pixel_values[0], (1, 2, 0))
    got = clip_preprocess_float(img, 224)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if kind == "real":  # the float32 round trip drops levels: truncation, not rounding
        assert (u8 != np.rint(img.astype(np.float64) * 255)).any()


@pytest.mark.parametrize("scales,routing_gates,drops", [
    ((1.0, 2.0, 3.0), False, [True, False, True]),   # CFG off at 1, on at 2 and 3
    ((2.0, 1.0, 3.0), False, [True, True, True]),
    ((2.0, 3.0), False, [False, True]),
    ((1.0, 2.0, 3.0), True, [False, False, True]),   # steer: one program
])
def test_the_sweep_drops_a_program_where_the_next_scale_needs_another(scales, routing_gates,
                                                                     drops):
    """Steer and guidance are program inputs, so a checkpoint's scales share
    a program; baseline mode runs scale 1 without CFG, another program, so
    the one before is dropped there and the sweep holds one pool at a time."""
    assert evaluate.drops_after(scales, routing_gates) == drops


def test_random_backbones_are_refused():
    bank = evaluate.FeatureBank(tiny_dadd())
    with pytest.raises(RuntimeError, match="random"):
        bank.inception(np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(RuntimeError, match="random"):
        bank.vgg(np.zeros((2, 32, 32, 3), np.float32))


def _random_variables(module, x, seed):
    """psd_tpu's init tree (shapes only) filled from a numpy seed."""
    tree = jax.eval_shape(lambda k: module.init(k, jnp.zeros(x)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) * np.float32(
                math.sqrt(2.0 / np.prod(shape[:-1])))
        if name in ("bias", "mean"):
            return rng.standard_normal(shape, np.float32) * np.float32(0.1)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def backbone_npz(tmp_path_factory):
    root = tmp_path_factory.mktemp("backbones")
    jax_save_npz(_random_variables(JaxInception(), (1, 299, 299, 3), 11), root / "incep.npz")
    jax_save_npz(_random_variables(JaxVGG(), (1, 224, 224, 3), 12), root / "vgg.npz")
    return ["--inception-params", str(root / "incep.npz"), "--vgg-params", str(root / "vgg.npz")]


def test_evaluate_cli_matches_psd_tpu(tmp_path, monkeypatch, backbone_npz):
    data = make_class_tree(tmp_path / "data", counts=(("test", 2),), classes=2)
    argv = ["--config", TINY, "--data-dir", str(data), "--split", "test", "--scales", "2.0",
            "--batch-images", "2", "--sampling-steps", "2", "--image-size", "32",
            "--max-per-class", "2", "--num-eval-seeds", "2", "--dtype", "fp32", "--seed", "5",
            *backbone_npz]
    jax_load, trees = seeded_load_params(tiny_dadd(seed=5))
    monkeypatch.setattr(jeval, "load_params", jax_load)

    class Bank(jeval.FeatureBank):  # batches of 8, not 32: less padding, the same features
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "batch": 8})

    monkeypatch.setattr(jeval, "FeatureBank", Bank)
    ref = jeval.main(argv + ["--output-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(evaluate, "load_params", port_load_params(trees))
    monkeypatch.setattr(augment, "initial_draws", chained_jax_draws(5, 6, 16))
    out = evaluate.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])

    assert [(r.checkpoint, r.scale, r.num_generated) for r in out] == [
        (r.checkpoint, r.scale, r.num_generated) for r in ref] == [("None", 2.0, 12)]
    runs = sorted(p.parent.name for p in (tmp_path / "jax").glob("*/metrics.json"))
    assert runs == sorted(p.parent.name for p in (tmp_path / "port").glob("*/metrics.json"))
    for run in runs:
        got = json.loads((tmp_path / "port" / run / "metrics.json").read_text())
        want = json.loads((tmp_path / "jax" / run / "metrics.json").read_text())
        assert set(got) == set(want) and set(got["per_class"]) == set(want["per_class"])
        assert set(got["per_class"]) == {"0", "1"}  # classes 2 and 3 have no real images
        for cls, m in want["per_class"].items():
            g = got["per_class"][cls]
            assert (g["n_real"], g["n_fake"]) == (m["n_real"], m["n_fake"]) == (2, 2)
            _close(g, m, f"{run} class {cls}")
        _close(got["overall"], want["overall"], f"{run} overall")
    assert json.loads((tmp_path / "port" / "comparison.json").read_text())[0]["scale"] == 2.0


def _close(got, want, where):
    """FID from bf16 Inception features on both sides (rounded at other
    points: the features agree to ≈ 1e-2 relative, tests/test_torch_
    backbones.py) within 5% relative, its std over the subsampling seeds
    within 5% of the FID (the seeds draw the same images here, so the std
    is rounding noise); CMMD (the tiny CLIP tower in fp32 on both sides)
    within 1e-4: the generated images agree within 1e-4, so a few of the
    processor's truncated bytes land one level apart, and the unbiased
    estimator over 2 real images amplifies that; precision and recall
    (shares of 2–4 samples from bf16 VGG features) equal within 1e-6."""
    for key, w in want.items():
        if key in ("n_real", "n_fake"):
            continue
        g = got[key]
        if key == "fid_std":
            assert g == pytest.approx(w, abs=5e-2 * want["fid"]), (where, key, g, w)
        elif key.startswith("fid"):
            assert g == pytest.approx(w, rel=5e-2), (where, key, g, w)
        elif key.startswith("cmmd"):
            assert g == pytest.approx(w, abs=1e-4), (where, key, g, w)
        else:
            assert g == pytest.approx(w, abs=1e-6), (where, key, g, w)


GATED_VAE = dict(block_out_channels=(128, 256), layers_per_block=1)


def test_second_checkpoint_equals_a_fresh_model(tmp_path, monkeypatch):
    """--vae-quant int8: the first checkpoint's frozen VAE (and the int8
    decoder weights computed from it) must not reach the second's images."""
    data = make_class_tree(tmp_path / "data", counts=(("test", 1),))
    base = tiny_dadd()

    def build(cfg, dtype, tome_ratio=0.0, tome_mode="branch", vae_quant="none", device="cpu",
              seed=0):
        assert vae_quant == "int8"
        return DADD(cfg, core_cfg=base.core_cfg, clip_cfg=base.clip_cfg, dtype=torch.float32,
                    vae_cfg=tiny_vae_config(quant="int8", **GATED_VAE), device=device, seed=seed)

    cks = {}
    for name, seed in (("a", 1), ("b", 2)):
        d = tmp_path / name / "7"
        d.mkdir(parents=True)
        (d / "state.json").write_text("{}")
        torch.save(tiny_dadd(seed=seed).core.state_dict(), d / "params.pt")
        cks[name] = str(d)
    like = jax.eval_shape(lambda k: JaxVAE(jax_tiny_vae(quant="int8", **GATED_VAE)).init(
        k, jnp.zeros((1, 16, 16, 3)), k), jax.random.PRNGKey(0))["params"]
    other = build(base.cfg, "fp32", vae_quant="int8", seed=9)
    frozen = to_flax_tree(other.vae.state_dict(), {k: like[k] for k in VAE_DECODE_KEYS})
    save_params_npz(frozen, Path(cks["a"]) / "frozen" / "vae.npz")

    runs = []

    def keep(*a, **k):
        fake, tput = generate_all(*a, **k)
        runs.append(fake)
        return fake, tput

    generate_all = evaluate.generate_all
    monkeypatch.setattr(evaluate, "build_model", build)
    monkeypatch.setattr(evaluate, "generate_all", keep)
    monkeypatch.setattr(evaluate, "evaluate_one_run", lambda *a, **k: ({}, {}))
    argv = ["--config", TINY, "--data-dir", str(data), "--split", "test", "--scales", "1.0",
            "1.0", "--batch-images", "1", "--sampling-steps", "2", "--image-size", "32",
            "--max-per-class", "1", "--vae-quant", "int8", "--device", "cpu"]
    evaluate.main(argv + ["--checkpoints", cks["a"], cks["b"], "--output-dir",
                          str(tmp_path / "both")])
    evaluate.main(argv + ["--checkpoints", cks["b"], "--output-dir", str(tmp_path / "b")])
    a, a_again, b_after_a, _, b_alone, _ = runs
    for c in range(4):
        np.testing.assert_array_equal(b_after_a[c], b_alone[c])
        np.testing.assert_array_equal(a_again[c], a[c])  # each scale draws from --seed anew
    assert not np.allclose(a[0], b_alone[0], atol=1e-3)


def test_encoder_stride_with_cfg_exits_as_psd_tpu(tmp_path):
    data = make_class_tree(tmp_path / "data", counts=(("test", 1),))
    argv = ["--config", baseline_config(tmp_path), "--data-dir", str(data), "--scales", "1.0",
            "3.0", "--encoder-stride", "2", "--output-dir", str(tmp_path / "out"), "--dtype",
            "fp32"]
    with pytest.raises(SystemExit) as want:
        jeval.main(argv)
    with pytest.raises(SystemExit) as got:
        evaluate.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "encoder-stride" in str(got.value)


def test_device_defaults_to_the_card(tmp_path):
    argv = ["--config", TINY, "--data-dir", str(tmp_path)]
    assert evaluate.build_argparser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate.main(argv + ["--output-dir", str(tmp_path / "o")])
