"""The port's augment factory (`python -m psd_tpu_torch.pipelines.augment`)
and its image writer against psd_tpu's, on the CPU.

  * `to_uint8` and the BMP writer (the native kernels) byte-equal to
    psd_tpu's; `AsyncImageWriter` writes the same files.
  * `collect_pending_jobs` and `copy_splits` on a synthetic class tree with
    colliding stems and outputs already written: the same jobs and files.
  * The CLI on configs/tiny_smoke.yaml (routing gates, steer 1.0, fp32, 32²,
    2 steps, `--batch-images 2`: 9 jobs in batches of 6 and 3, the last
    padded) against psd_tpu's `augment.main`: psd_tpu's parameters (its
    `load_params` recorded, bridged) and JAX's chained draws (`fold_in(key,
    b)` at every batch, one latent per image) handed to the port's
    `initial_draws`. The images it writes within atol 1e-4 (fp32 through
    two sampler steps and the decoder, the band of
    tests/test_torch_generate.py), the BMP files within one level, the same
    names, and a second run finds nothing pending.
  * The batch's conditioning: CFG against the zero-AOE conditioning only in
    baseline mode with guidance ≠ 1, the ragged chunk padded.
  * Refusals and defaults: `--encoder-stride > 1` with CFG exits as
    psd_tpu's does; `--device` defaults to the card and raises without one.
"""

import filecmp
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import psd_tpu.pipelines.augment as jaug
from psd_tpu.data.limuc import LIMUCDataset as JaxLIMUC
from psd_tpu.utils import image_io as jio
from psd_tpu_torch.data.limuc import LIMUCDataset
from psd_tpu_torch.pipelines import augment
from psd_tpu_torch.testing import tiny_dadd
from psd_tpu_torch.utils import image_io
from tests.torch_cli_parity import TINY, baseline_config, chained_jax_draws, few_threads
from tests.torch_cli_parity import make_class_tree as make_tree


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


@pytest.mark.parametrize("shape", [(32, 32, 3), (17, 29, 3), (5, 3, 3)])

def test_uint8_and_bmp_bytes_match_psd_tpu(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).uniform(-0.2, 1.2, shape).astype(np.float32)
    img[0, 0] = [0.5 / 255, 254.5 / 255, 1.0]  # the rounding's edges
    np.testing.assert_array_equal(image_io.to_uint8(img), jio.to_uint8(img))
    image_io.save_image(img, tmp_path / "port.bmp")
    jio.save_image(img, tmp_path / "jax.bmp")
    assert (tmp_path / "port.bmp").read_bytes() == (tmp_path / "jax.bmp").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.bmp")),
                                  image_io.to_uint8(img))


def test_async_writer_writes_psd_tpu_files(tmp_path):
    imgs = np.random.default_rng(1).uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    port, ref = image_io.AsyncImageWriter(), jio.AsyncImageWriter()
    for i, img in enumerate(imgs):
        ext = "bmp" if i % 2 else "png"
        port.submit(img, tmp_path / "port" / f"a{i}" / f"x.{ext}")
        ref.submit(img, tmp_path / "jax" / f"a{i}" / f"x.{ext}")
    port.close()
    ref.close()
    for i in range(4):
        ext = "bmp" if i % 2 else "png"
        a, b = tmp_path / "port" / f"a{i}" / f"x.{ext}", tmp_path / "jax" / f"a{i}" / f"x.{ext}"
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    assert filecmp.cmp(tmp_path / "port/a1/x.bmp", tmp_path / "jax/a1/x.bmp", shallow=False)


def test_collect_pending_jobs_and_copy_splits_match_psd_tpu(tmp_path):
    data = make_tree(tmp_path / "data")
    out_p, out_j = tmp_path / "out_port", tmp_path / "out_jax"
    # one output already written under each name convention: both skip it
    for out in (out_p, out_j):
        (out / "train" / "Mayo_2").mkdir(parents=True)
        (out / "train" / "Mayo_2" / "generated_im0_src0_to_2.png").write_bytes(b"")
        (out / "train" / "Mayo_0" / "x").mkdir(parents=True)
    ds = LIMUCDataset(data / "train", image_size=32, return_clip=False)
    jds = JaxLIMUC(data / "train", image_size=32, return_clip=False)
    for max_images, ext in ((None, "bmp"), (3, "png")):
        got = augment.collect_pending_jobs(ds, out_p, 4, max_images, ext)
        want = jaug.collect_pending_jobs(jds, out_j, 4, max_images, ext)
        assert [(i, s, t, p.relative_to(out_p)) for i, s, t, p in got] == [
            (i, s, t, p.relative_to(out_j)) for i, s, t, p in want]
    # identical stems in two classes get two names
    names = [p.name for *_, p in augment.collect_pending_jobs(ds, out_p, 4)]
    assert len(names) == len(set(names)) == 8 * 3 - 1
    augment.copy_splits(data, out_p)
    jaug.copy_splits(data, out_j)
    files = sorted(p.relative_to(out_p) for p in out_p.rglob("*"))
    assert files == sorted(p.relative_to(out_j) for p in out_j.rglob("*"))
    assert len(list(out_p.glob("val/*/*.png"))) == 8


class RecordingWriter(image_io.AsyncImageWriter):
    """AsyncImageWriter keeping each submitted float image by path."""

    seen = {}

    def submit(self, img, path):
        type(self).seen[Path(path).name] = np.asarray(img)
        super().submit(img, path)


def test_augment_cli_matches_psd_tpu(tmp_path, monkeypatch):
    data = make_tree(tmp_path / "data")
    argv = ["--config", TINY, "--data-dir", str(data), "--batch-images", "2",
            "--sampling-steps", "2", "--image-size", "32", "--max-images", "3",
            "--copy-splits", "--dtype", "fp32", "--seed", "3"]
    seen = {}
    jax_load = jaug.load_params

    def recording(*a, **k):
        seen["trees"] = jax.device_get(jax_load(*a, **k))
        return seen["trees"]

    class JaxRecording(jio.AsyncImageWriter):
        images = {}

        def submit(self, img, path):
            type(self).images[Path(path).name] = np.asarray(img)
            super().submit(img, path)

    monkeypatch.setattr(jaug, "load_params", recording)
    monkeypatch.setattr(jaug, "AsyncImageWriter", JaxRecording)
    ref = jaug.main(argv + ["--output-dir", str(tmp_path / "jax")])

    monkeypatch.setattr(augment, "load_params",
                        lambda model, checkpoint, use_ema=False: model.load_flax(*seen["trees"]))
    monkeypatch.setattr(augment, "initial_draws", chained_jax_draws(3, 6, 16))
    monkeypatch.setattr(augment, "AsyncImageWriter", RecordingWriter)
    out = augment.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])

    assert out["generated"] == ref["generated"] == 9
    assert len(out["batch_seconds"]) == 2  # 6, then 3 padded to 6
    got, want = RecordingWriter.seen, JaxRecording.images
    assert sorted(got) == sorted(want) and len(got) == 9
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.*"))
    for f in files:
        if f.suffix == ".bmp":
            a = np.asarray(Image.open(tmp_path / "port" / f), np.int16)
            b = np.asarray(Image.open(tmp_path / "jax" / f), np.int16)
            assert np.abs(a - b).max() <= 1, f
    # resumable: nothing pending the second time
    again = augment.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert again["generated"] == 0


@pytest.mark.parametrize("routing,guidance", [(True, 3.0), (False, 1.0), (False, 3.0)])
def test_conditioning_cfg_only_in_baseline_mode(tmp_path, routing, guidance):
    """psd_tpu's augment/evaluate batches: CFG against the zero-AOE
    conditioning only without routing gates and with guidance ≠ 1; the
    ragged chunk padded by repeating its last job."""
    data = make_tree(tmp_path / "data", counts=(("train", 1),))
    model = tiny_dadd(routing=routing)
    ds = LIMUCDataset(data / "train", image_size=32, clip_size=model.clip_cfg.image_size)
    chunk = [(i, float(i), float((i + 1) % 4), None) for i in range(3)]
    cond, uncond, g, n_real = augment.conditioning(model, ds, chunk, 4, guidance)
    assert n_real == 3 and cond.shape[0] == 4
    feats = model.encode_image_clip(np.stack([ds.load(i)["clip_image"] for i in (0, 1, 2, 2)]))
    tgt, src = np.float32([1, 2, 3, 3]), np.float32([0, 1, 2, 2])
    np.testing.assert_array_equal(cond, model.prepare_inference_cond(tgt, src, feats))
    if routing or guidance == 1.0:
        assert uncond is None and g == 1.0
    else:
        assert g == guidance
        np.testing.assert_array_equal(
            uncond, model.prepare_inference_cond(tgt, src, feats, zero_aoe=True))


def test_encoder_stride_with_cfg_exits_as_psd_tpu(tmp_path):
    data = make_tree(tmp_path / "data", counts=(("train", 1),))
    argv = ["--config", baseline_config(tmp_path), "--data-dir", str(data), "--output-dir",
            str(tmp_path / "out"), "--guidance-scale", "3", "--encoder-stride", "2"]
    with pytest.raises(SystemExit) as want:
        jaug.main(argv)
    with pytest.raises(SystemExit) as got:
        augment.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "encoder-stride" in str(got.value)


def test_device_defaults_to_the_card(tmp_path):
    argv = ["--config", TINY, "--data-dir", str(tmp_path), "--output-dir", str(tmp_path / "o")]
    assert augment.build_argparser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            augment.main(argv)
