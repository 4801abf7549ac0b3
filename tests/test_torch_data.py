"""The port's LIMUC data pipeline against psd_tpu's, on the CPU: the native
image kernels byte for byte, items with augmentation off and on (one
thread: the augment's draws are then in item order on both sides), the
loader's batch order, and `pad_batch`.

Tolerances: exact everywhere except the CLIP view, which psd_tpu takes
from `CLIPImageProcessor` and the port from its own PIL/numpy copy:
within 1e-6.
"""

import numpy as np
import pytest
from PIL import Image

from psd_tpu.data import AugmentConfig as JaxAugmentConfig
from psd_tpu.data import DataLoader as JaxDataLoader
from psd_tpu.data import LIMUCDataset as JaxLIMUCDataset
from psd_tpu.data import native as jax_native
from psd_tpu.pipelines.common import pad_batch as jax_pad_batch
from psd_tpu_torch.data import AugmentConfig, DataLoader, LIMUCDataset, native
from psd_tpu_torch.pipelines.common import pad_batch

CLIP_ATOL = 1e-6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A class-per-directory tree of unequal classes, non-square images
    larger than the 224 center crop, and a file the scan must skip."""
    root = tmp_path_factory.mktemp("limuc") / "train"
    rng = np.random.default_rng(0)
    for cls, n in {"Mayo_0": 5, "Mayo_1": 3, "Mayo_2": 2, "Mayo_3": 2}.items():
        (root / cls).mkdir(parents=True)
        for i in range(n):
            h, w = int(rng.integers(230, 300)), int(rng.integers(230, 320))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / cls / f"img_{i}.png")
    (root / "Mayo_0" / "notes.txt").write_text("not an image")
    return root


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(1).integers(0, 256, (120, 160, 3), dtype=np.uint8)


def test_native_library_is_built_under_build(img):
    path = native.library_path()
    native.library()
    assert path.exists()
    assert path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-3:] == ("build", "psd_tpu_torch", "native")
    assert jax_native.HAVE_NATIVE


@pytest.mark.parametrize("shape,out", [((120, 160), (64, 80)), ((64, 64), (224, 224)),
                                       ((100, 37), (224, 224)), ((768, 1024), (256, 256)),
                                       ((224, 224), (224, 224))])
def test_resize_bilinear_is_psd_tpus(shape, out):
    src = np.random.default_rng(2).integers(0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(src, *out),
                                  jax_native.resize_bilinear(src, *out))


@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      ((0.48145466, 0.4578275, 0.40821073),
                                       (0.26862954, 0.26130258, 0.27577711))], ids=["sd", "clip"])
def test_normalize_is_psd_tpus(img, mean, std):
    ours, ref = native.normalize(img, mean, std), jax_native.normalize(img, mean, std)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_scan_matches_psd_tpu(tree):
    ours = LIMUCDataset(tree, image_size=64, return_clip=False)
    ref = JaxLIMUCDataset(tree, image_size=64, return_clip=False)
    assert ours.class_to_idx == ref.class_to_idx
    assert ours.samples == ref.samples and len(ours) == 12
    np.testing.assert_array_equal(ours.class_counts, ref.class_counts)
    np.testing.assert_array_equal(ours.balanced_weights(), ref.balanced_weights())


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_items_match_psd_tpu(tree, augment):
    """Every item in order from datasets of the same seed: the SD view
    exact, the CLIP view within 1e-6, the label exact; with augmentation
    the draws of one rng stream each."""
    kw = dict(image_size=64, return_clip=True, seed=5)
    ours = LIMUCDataset(tree, augment=AugmentConfig() if augment else None, **kw)
    ref = JaxLIMUCDataset(tree, augment=JaxAugmentConfig() if augment else None, **kw)
    for i in range(len(ours)):
        a, b = ours.load(i), ref.load(i)
        assert a.keys() == b.keys()
        assert a["image"].dtype == a["clip_image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["label"] == b["label"]
        np.testing.assert_allclose(a["clip_image"], b["clip_image"], rtol=0, atol=CLIP_ATOL)
    assert ours.rng.random() == ref.rng.random()


@pytest.mark.parametrize("class_balanced,shuffle,drop_last", [
    (True, True, True), (False, True, True), (False, True, False), (False, False, False)],
    ids=["balanced", "shuffled", "shuffled-ragged", "in-order-ragged"])
def test_loader_batches_match_psd_tpu(tree, class_balanced, shuffle, drop_last):
    """Two epochs of batches of 5: the same items in the same order and the
    same count (12 items: 2 batches, or 3 with the ragged last one)."""
    kw = dict(batch_size=5, class_balanced=class_balanced, shuffle=shuffle,
              drop_last=drop_last, num_threads=1, seed=7)
    ours = DataLoader(LIMUCDataset(tree, image_size=32, return_clip=False), **kw)
    ref = JaxDataLoader(JaxLIMUCDataset(tree, image_size=32, return_clip=False), **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_prefetches_from_threads(tree):
    """Many threads: the same batches, in order, as one thread (no augment)."""
    ds = LIMUCDataset(tree, image_size=32, return_clip=True)
    one = list(DataLoader(ds, batch_size=4, num_threads=1, seed=3))
    many = list(DataLoader(ds, batch_size=4, num_threads=4, prefetch=1, seed=3))
    assert len(one) == len(many) == 3
    for a, b in zip(one, many):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert many[0]["clip_image"].shape == (4, 224, 224, 3)


@pytest.mark.parametrize("n_real", [1, 3, 4])
def test_pad_batch_matches_psd_tpu(n_real):
    rng = np.random.default_rng(n_real)
    arrays = [rng.standard_normal((n_real, 2, 3)).astype(np.float32),
              np.arange(n_real, dtype=np.float32)]
    got, n = pad_batch(arrays, 4)
    want, m = jax_pad_batch(arrays, 4)
    assert n == m == n_real
    for a, b in zip(got, want):
        assert a.shape[0] == 4
        np.testing.assert_array_equal(a, b)
