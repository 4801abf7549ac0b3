"""The port's MES classifier CLI (`python -m psd_tpu_torch.pipelines.classify`)
and its dataset against psd_tpu's, on the CPU.

  * `MESClassificationDataset`: the same synthetic-only, balanced samples
    and, with the PIL augments on, the same arrays item by item and batch by
    batch (one numpy generator, the same draw order, the native resize and
    normalize).
  * The optimizer: psd_tpu's optax chain (global-norm clip 1.0, the
    gradient scaled by cosine(count) / lr, then sgd / adam / adamw; inside
    MultiSteps when accumulating; the freeze's masks on the gradients and
    the updates) against `ClassifierOptimizer` on the same gradients, for
    each optimizer plain, with accumulation 2 and with a freeze: the
    parameters after every micro-step within 1e-6 (float32 updates in
    another order).
  * `focal_ce_loss` and `apply_yaml_config` against psd_tpu's.
  * The CLI (ResNet-18 at 32², batch 8, 2 epochs, SGD at lr 0.05 with
    accumulation 2 and the backbone frozen for the first epoch, label
    smoothing 0.1, dropout 0, top-1 keeping) against psd_tpu's
    `classify.main` from psd_tpu's initial variables (recorded, bridged
    in): the logged train losses within 1e-4 relative, the final params and
    batch_stats within 1e-6 absolute or 1e-5 relative (they read ≤ 1.4e-7
    on params that moved 1e-5–1e-2, ≤ 3e-6 on running variances near 1),
    the val confusion matrices equal. SGD, because Adam turns the float32
    rounding of near-zero gradient components into steps of ±lr, so its
    parameters compare only on equal gradients (the optimizer test). Each
    package's `last.npz` loads in the other and gives the other's logits.
  * `--task regress`, and `--device` defaulting to the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import psd_tpu.pipelines.classify as jcls
from psd_tpu.convert.io import load_params_npz as jax_load_npz
from psd_tpu.data.classification import MESClassificationDataset as JaxMES
from psd_tpu.models.resnet import ResNet as JaxResNet
from psd_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from psd_tpu_torch.convert.from_jax import _leaves, load_variables_, to_flax_variables
from psd_tpu_torch.convert.npz import load_params_npz
from psd_tpu_torch.data.classification import MESClassificationDataset
from psd_tpu_torch.models.resnet import ResNet, ResNetConfig
from psd_tpu_torch.pipelines import classify
from tests.torch_cli_parity import ROOT, few_threads, make_class_tree


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


@pytest.fixture(scope="module")

def synthetic_tree(tmp_path_factory):
    """train/<class>/ with real images and 6–9 generated ones a class
    (unequal, so balancing draws), val/<class>/ real."""
    root = make_class_tree(tmp_path_factory.mktemp("cls"), counts=(("train", 2), ("val", 2)),
                           size=(48, 40))
    rng = np.random.default_rng(1)
    from PIL import Image

    for c in range(4):
        for i in range(6 + c):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), np.uint8)).save(
                root / "train" / f"Mayo_{c}" / f"generated_im{i}_src9_to_{c}.bmp")
    return root


def test_dataset_matches_psd_tpu(synthetic_tree):
    port = MESClassificationDataset(synthetic_tree, "train", 24, seed=3)
    ref = JaxMES(synthetic_tree, "train", 24, seed=3)
    assert port.samples == ref.samples and len(port) == 24
    assert all("generated" in p.name for p, _ in port.samples)
    np.testing.assert_array_equal(port.class_counts, ref.class_counts)
    for i in (0, 5, 23, 5):
        a, b = port.load(i), ref.load(i)
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["label"] == b["label"] and a["image"].dtype == np.float32
    for a, b in zip(port.batches(5), ref.batches(5)):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    val = MESClassificationDataset(synthetic_tree, "val", 24)
    assert len(val) == 8 and not val.augment
    everything = MESClassificationDataset(synthetic_tree, "train", 24, synthetic_only_train=False)
    assert len(everything) == 4 * 8  # balanced down to Mayo_0's 2 real + 6 generated


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Linear(3, 5)
        self.fc = nn.Linear(5, 2)


def _flax(module):
    return {n: {"kernel": m.weight.detach().numpy().T.copy(), "bias": m.bias.detach().numpy().copy()}
            for n, m in (("body", module.body), ("fc", module.fc))}


@pytest.mark.parametrize("mode", ["plain", "accumulate", "freeze"])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_psd_tpu_chain(name, mode):
    lr, wd, decay = 1e-2, 1e-2, 3
    accum = 2 if mode == "accumulate" else 1
    torch.manual_seed(0)
    model = Tiny()
    params = jax.tree_util.tree_map(jnp.asarray, _flax(model))
    tx = {"sgd": optax.sgd(lr, momentum=0.9), "adam": optax.adam(lr),
          "adamw": optax.adamw(lr, weight_decay=wd)}[name]
    sched = optax.cosine_decay_schedule(lr, decay)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.scale_by_schedule(lambda s: sched(s) / lr), tx)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    state = tx.init(params)

    def mask(tree, freeze):  # psd_tpu's _mask_frozen_updates
        return {k: v if k == "fc" else jax.tree_util.tree_map(lambda u: u * (1.0 - freeze), v)
                for k, v in tree.items()}

    opt = classify.ClassifierOptimizer(model, name, lr, wd, decay, accumulate=accum)
    rng = np.random.default_rng(1)
    for step in range(6):
        freeze = float(mode == "freeze" and step < 3)
        g = {"body": {"kernel": rng.standard_normal((3, 5)), "bias": rng.standard_normal(5)},
             "fc": {"kernel": rng.standard_normal((5, 2)), "bias": rng.standard_normal(2)}}
        g = jax.tree_util.tree_map(lambda a: (a * (0.2 + step)).astype(np.float32), g)
        upd, state = tx.update(mask(g, freeze), state, params)
        params = optax.apply_updates(params, mask(upd, freeze))
        grads = [torch.from_numpy(np.ascontiguousarray(g[m]["kernel"].T)) if leaf == "weight"
                 else torch.from_numpy(g[m]["bias"])
                 for m, leaf in (n.split(".") for n, _ in model.named_parameters())]
        opt.step(grads, bool(freeze))
        got = _flax(model)
        for path, leaf in _leaves(jax.device_get(params)):
            np.testing.assert_allclose(got[path[0]][path[1]], leaf, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {mode} step {step} {path}")
    assert opt.count == 6 // accum
    if mode == "freeze":  # frozen three steps: the body moved only after
        assert opt.count == 6


@pytest.mark.parametrize("gamma,smoothing", [(0.0, 0.0), (0.0, 0.1), (2.0, 0.0), (2.0, 0.2)])
def test_focal_ce_loss_matches_psd_tpu(gamma, smoothing):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 6).astype(np.int32)
    got = classify.focal_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), 4, gamma,
                                 smoothing)
    want = jcls.focal_ce_loss(jnp.asarray(logits), jnp.asarray(labels), 4, gamma, smoothing)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("extra", [[], ["--lr", "3e-4", "--epochs", "4", "--task", "classify"]])
def test_yaml_config_merges_as_psd_tpu(extra, tmp_path):
    argv = ["--config", str(ROOT / "configs" / "train_classifier.yaml"), *extra]
    got = vars(classify.apply_yaml_config(classify.build_argparser().parse_args(argv), argv))
    want = vars(jcls.apply_yaml_config(jcls.build_argparser().parse_args(argv), argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["label_smoothing"] == 0.1 and got["batch_size"] == 32
    reg = tmp_path / "reg.yaml"
    reg.write_text("logging: {monitor_metric: val/rmse}\n")
    args = classify.apply_yaml_config(classify.build_argparser().parse_args(
        ["--config", str(reg)]), ["--config", str(reg)])
    assert args.task == "regress"


def test_classify_cli_matches_psd_tpu(synthetic_tree, tmp_path, monkeypatch):
    argv = ["--data-dir", str(synthetic_tree), "--image-size", "32", "--batch-size", "8",
            "--epochs", "2", "--dropout", "0", "--label-smoothing", "0.1", "--save-top-k", "1",
            "--optimizer", "sgd", "--lr", "0.05", "--accumulate-grad-batches", "2",
            "--freeze-backbone-epochs", "1", "--seed", "4"]
    seen = {}

    class Recording(JaxResNet):
        def init(self, *a, **k):
            seen["init"] = jax.device_get(super().init(*a, **k))
            return seen["init"]

    monkeypatch.setattr(jcls, "ResNet", Recording)
    ref = jcls.main(argv + ["--output-dir", str(tmp_path / "jax")])

    build = classify.build_classifier

    def bridged(args, device):
        return load_variables_(build(args, device), seen["init"])

    monkeypatch.setattr(classify, "build_classifier", bridged)
    out = classify.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])

    assert len(out) == len(ref) == 2
    for g, w in zip(out, ref):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
        assert g["confusion_matrix"] == w["confusion_matrix"]
        assert np.asarray(g["confusion_matrix"]).sum() == 8
        assert g["qwk"] == pytest.approx(w["qwk"], abs=1e-9)
    logged = [json.loads(line) for line in (tmp_path / "port" / "metrics.jsonl").read_text()
              .splitlines()]
    assert [r["train_loss"] for r in logged] == [r["train_loss"] for r in out]
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {"last.npz", "best.npz", "best_confusion_matrix.json", "history.json"} <= set(names)

    mine, theirs = load_params_npz(tmp_path / "port" / "last.npz"), jax_load_npz(
        tmp_path / "jax" / "last.npz")
    assert {p for p, _ in _leaves(mine)} == {p for p, _ in _leaves(theirs)}
    for path, leaf in _leaves(theirs):
        node = mine
        for p in path:
            node = node[p]
        np.testing.assert_allclose(node, leaf, rtol=1e-5, atol=1e-6, err_msg="/".join(path))

    # each package reads the other's checkpoint
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(np.float32)
    port_model = load_variables_(ResNet(ResNetConfig(dropout=0.0)), theirs).eval()
    jm = JaxResNet(JaxResNetConfig(dropout=0.0))
    with torch.no_grad():
        np.testing.assert_allclose(port_model(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(theirs, jnp.asarray(x), False)),
                                   rtol=0, atol=1e-4)
        port_own = load_variables_(ResNet(ResNetConfig(dropout=0.0)), mine).eval()
        np.testing.assert_allclose(np.asarray(jm.apply(mine, jnp.asarray(x), False)),
                                   port_own(torch.from_numpy(x)).numpy(), rtol=0, atol=1e-4)
    assert to_flax_variables(port_own)["batch_stats"]["bn1"]["var"].shape == (64,)


def test_regress_task_and_backbone_params(synthetic_tree, tmp_path):
    first = classify.main(["--data-dir", str(synthetic_tree), "--image-size", "32",
                           "--batch-size", "4", "--epochs", "1", "--save-top-k", "0",
                           "--output-dir", str(tmp_path / "a"), "--device", "cpu"])
    hist = classify.main(["--data-dir", str(synthetic_tree), "--image-size", "32",
                          "--batch-size", "4", "--epochs", "1", "--task", "regress",
                          "--backbone-params", str(tmp_path / "a" / "last.npz"),
                          "--output-dir", str(tmp_path / "r"), "--device", "cpu"])
    assert np.isfinite(first[0]["qwk"])
    assert {"rmse", "mae", "rounded_acc", "qwk"} <= set(hist[0]) and np.isfinite(hist[0]["rmse"])
    assert (tmp_path / "r" / "best.npz").exists()
    # the backbone came from the classifier's checkpoint, the head is the regressor's own
    a, r = load_params_npz(tmp_path / "a" / "last.npz"), load_params_npz(tmp_path / "r" /
                                                                         "last.npz")
    assert r["params"]["fc"]["kernel"].shape == (512, 1)
    assert a["params"]["fc"]["kernel"].shape == (512, 4)


def test_device_defaults_to_the_card(tmp_path):
    assert classify.build_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            classify.main(["--data-dir", str(tmp_path), "--output-dir", str(tmp_path / "o")])
