"""psd_tpu's product loop (tests/test_product_loop.py) on the port alone, on
the CPU: train the diffusion model two steps from PNGs → the augment
factory writes a balanced synthetic dataset from the checkpoint → the
classifier trains on the `generated` files only → QWK and accuracy on the
real val images. Each stage is held to psd_tpu elsewhere
(tests/test_torch_{train_cli,augment,classify}.py); this test exercises the
seams: the checkpoint handoff, the file layout the factory writes against
what `MESClassificationDataset` filters on, the split copies, the label
encoding.
"""

import json

import numpy as np
import pytest

from psd_tpu_torch.data.classification import MESClassificationDataset
from psd_tpu_torch.pipelines import augment, classify, train
from tests.torch_cli_parity import TINY, few_threads, make_class_tree


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def test_train_augment_classify_chain(tmp_path):
    data_root = make_class_tree(tmp_path / "limuc", stem="real_im")

    # stage 1: the diffusion model, two steps on the tiny config
    run_dir = tmp_path / "diffusion_run"
    common = ["--config", TINY, f"dataset.dataset_path={data_root}", "dataset.batch_size=4",
              "training.log_every_n_steps=1", "training.check_val_every_n_epochs=0",
              "--max-steps", "2", "--output-dir", str(run_dir), "--device", "cpu"]
    # without torchrun the world is one process: a mesh of two ranks raises
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train.main(common + ["--dp", "2"])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train.main(common + ["--fsdp", "2"])
    out = train.main(common + ["--dp", "1"])
    assert out["state"].step == 2
    ckpt_dir = run_dir / "checkpoints"
    assert ckpt_dir.exists()

    # stage 2: the augment factory from the checkpoint
    synth_root = tmp_path / "synthetic"
    result = augment.main([
        "--config", TINY, "--checkpoint", str(ckpt_dir), "--data-dir", str(data_root),
        "--output-dir", str(synth_root), "--batch-images", "2", "--sampling-steps", "2",
        "--image-size", "32", "--copy-splits", "--dtype", "fp32", "--device", "cpu"])
    assert result["generated"] == 8 * 3  # every train image × the 3 other classes
    gen = sorted(synth_root.glob("train/*/generated_*.bmp"))
    assert len(gen) == 24
    for c in range(4):  # 2 sources from each other class
        assert len(list((synth_root / "train" / f"Mayo_{c}").glob("generated_*"))) == 6
    assert len(list(synth_root.glob("train/*/real_im*.png"))) == 8
    assert len(list(synth_root.glob("val/*/real_im*.png"))) == 8

    # stage 3: the classifier on the synthetic images only, judged on real val
    train_ds = MESClassificationDataset(synth_root, "train", 32)
    assert len(train_ds) == 24
    assert all("generated" in p.name for p, _ in train_ds.samples)
    val_ds = MESClassificationDataset(synth_root, "val", 32)
    assert all("real" in p.name for p, _ in val_ds.samples)

    cls_dir = tmp_path / "classifier_run"
    hist = classify.main(["--data-dir", str(synth_root), "--backbone", "resnet18",
                          "--image-size", "32", "--batch-size", "8", "--epochs", "1",
                          "--save-top-k", "1", "--output-dir", str(cls_dir), "--device", "cpu"])
    m = hist[-1]
    assert np.isfinite(m["qwk"]) and -1.0 <= m["qwk"] <= 1.0
    assert np.isfinite(m["acc_micro"]) and 0.0 <= m["acc_micro"] <= 1.0
    cm = np.asarray(m["confusion_matrix"])
    assert cm.shape == (4, 4) and cm.sum() == 8  # all 8 real val images
    assert (cls_dir / "best.npz").exists()
    assert json.loads((cls_dir / "best_confusion_matrix.json").read_text())["epoch"] == 0
