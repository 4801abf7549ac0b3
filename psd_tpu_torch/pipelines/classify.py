"""MES classifier / judge-regressor training CLI.

    python -m psd_tpu_torch.pipelines.classify --config configs/train_classifier.yaml \\
        --data-dir dataset/limuc_synthetic_balanced

Counterpart of `psd_tpu/pipelines/classify.py`, with its flags, YAML schema
and outputs: a ResNet-18/34/50/101 (`models/resnet.py`) with a dropout head,
trained on the synthetic-only balanced train split
(`data/classification.py`) and judged on real val images each epoch (the
metric battery, `metrics/classification.py`); CE or focal loss with label
smoothing, or the `--task regress` judge's MSE; a backbone freeze for the
first `--freeze-backbone-epochs`; gradient accumulation; early stopping
and top-k keeping on val QWK (val RMSE for the judge). Writes
`metrics.jsonl`, `history.json`, `best_confusion_matrix.json`, and
`last.npz`, `epochNNN.npz` (the top k) and `best.npz`.

  * Device: `--device cuda` (the default; "auto" is the same) runs on the
    card and raises without one; only `--device cpu` runs on the CPU.
  * The optimizer is psd_tpu's optax chain computed in torch
    (`ClassifierOptimizer`): the optax global-norm clip at 1.0, the gradient
    scaled by cosine(count) / lr (the schedule scales the clipped gradient
    before the optimizer; under Adam it nearly cancels), then SGD (momentum
    0.9), Adam or AdamW at the constant `--lr`; with accumulation all of it
    runs once every k micro-batches on their mean gradient, and the
    schedule counts optimizer steps.
  * The freeze zeroes the gradients and the updates of every parameter but
    the head's (`fc`) while it lasts: no moment accumulates, no weight decay
    moves them.
  * Checkpoints are psd_tpu's flat `::`-keyed npz of flax's
    `{params, batch_stats}` (`convert/npz.py`, `convert/from_jax.py::
    to_flax_variables`), so each package reads the other's classifier, and
    `--backbone-params` takes psd_tpu-converted ImageNet weights.
  * Dropout draws from torch's generator, seeded with `--seed`; they
    cannot match JAX's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.from_jax import load_variables_, to_flax_variables
from ..convert.npz import load_params_npz, save_params_npz
from ..core.config import _yaml_load
from ..data.classification import MESClassificationDataset
from ..metrics.classification import (classification_report, confusion_matrix,
                                      regression_report)
from ..models.init import flax_init_
from ..models.resnet import ResNet, ResNetConfig
from ..train.optim import clip_by_global_norm_
from ..utils.logging import MetricLogger
from .common import add_device_arg, cli_device

HEAD = "fc"
CLIP_NORM = 1.0  # the global-norm gradient clip, psd_tpu's


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MES classifier/judge training (GPU)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config in the reference schema (configs/train_classifier.yaml); "
                        "explicit CLI flags override config values")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--task", type=str, default="classify", choices=["classify", "regress"])
    p.add_argument("--backbone", type=str, default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50", "resnet101"])
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adam", "adamw", "sgd"])
    p.add_argument("--loss", type=str, default="ce", choices=["ce", "focal"])
    p.add_argument("--focal-gamma", type=float, default=2.0)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--accumulate-grad-batches", type=int, default=1,
                   help="average grads over k micro-batches per optimizer step")
    p.add_argument("--freeze-backbone-epochs", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--early-stop-patience", type=int, default=0)
    p.add_argument("--save-top-k", type=int, default=3,
                   help="keep the k best checkpoints by the monitored metric + last")
    p.add_argument("--synthetic-only", action="store_true", default=True)
    p.add_argument("--no-synthetic-only", dest="synthetic_only", action="store_false")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", type=str, default="runs/classifier")
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--backbone-params", type=str, default=None,
                   help=".npz ImageNet-pretrained backbone (psd_tpu's format)")
    add_device_arg(p)
    return p


# YAML path (dot-joined) → argparse dest, the reference schema's
_YAML_TO_ARG = {
    "model.name": "backbone",
    "model.num_classes": "num_classes",
    "model.dropout": "dropout",
    "model.freeze_backbone_epochs": "freeze_backbone_epochs",
    "dataset.data_root": "data_dir",
    "dataset.image_size": "image_size",
    "training.batch_size": "batch_size",
    "training.max_epochs": "epochs",
    "training.learning_rate": "lr",
    "training.weight_decay": "weight_decay",
    "training.optimizer": "optimizer",
    "training.loss_type": "loss",
    "training.accumulate_grad_batches": "accumulate_grad_batches",
    "training.focal_gamma": "focal_gamma",
    "training.label_smoothing": "label_smoothing",
    "logging.save_top_k": "save_top_k",
    "early_stopping.patience": "early_stop_patience",
    "checkpoint.dirpath": "output_dir",
    "seed": "seed",
}


def apply_yaml_config(args, argv):
    """Fill every argument the command line did not set explicitly from the
    YAML (`_YAML_TO_ARG`); `logging.monitor_metric: val/rmse` selects the
    regressor unless `--task` is given."""
    with open(args.config) as f:
        raw = _yaml_load(f) or {}

    probe = build_argparser()
    for action in probe._actions:
        action.default = argparse.SUPPRESS
        action.required = False
    explicit = vars(probe.parse_args(argv))

    def get(dotted):
        node = raw
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    for dotted, dest in _YAML_TO_ARG.items():
        val = get(dotted)
        if val is not None and dest not in explicit:
            setattr(args, dest, type(getattr(args, dest))(val)
                    if getattr(args, dest) is not None else val)
    if get("logging.monitor_metric") == "val/rmse" and "task" not in explicit:
        args.task = "regress"
    return args


def focal_ce_loss(logits, labels, num_classes: int, gamma: float = 0.0,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy with label smoothing and optional focal modulation,
    averaged over the batch."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if smoothing > 0:
        onehot = onehot * (1 - smoothing) + smoothing / num_classes
    ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    if gamma > 0:
        ce = (1 - torch.exp(-ce)) ** gamma * ce
    return ce.mean()


def cosine_scale(count: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps)(count) / lr, in float32."""
    f32 = np.float32
    c = f32(min(count, decay_steps))
    return float(f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps))))


class ClassifierOptimizer:
    """psd_tpu's classifier optimizer: `chain(clip_by_global_norm(1.0),
    scale_by_schedule(cosine(count) / lr), sgd | adam | adamw)`, inside
    `MultiSteps(k)` when accumulating, with the freeze's masks on the
    gradients and the updates of every parameter outside the head."""

    def __init__(self, model: torch.nn.Module, name: str, lr: float, weight_decay: float,
                 decay_steps: int, accumulate: int = 1):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.head = [n.split(".")[0] == HEAD for n, _ in named]
        if name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr, momentum=0.9)
        elif name == "adam":
            self.opt = torch.optim.Adam(self.params, lr, eps=1e-8)
        elif name == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr, eps=1e-8, weight_decay=weight_decay)
        else:
            raise ValueError(f"optimizer must be sgd, adam or adamw, got {name!r}")
        self.decay_steps = max(int(decay_steps), 1)
        self.accumulate = max(int(accumulate), 1)
        self.count = 0      # optimizer steps applied (the schedule's count)
        self.mini_step = 0  # micro-steps into the current accumulation
        self.acc = None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], freeze: bool) -> bool:
        """Fold one micro-batch's gradients (one per parameter) in; True
        when the optimizer stepped."""
        grads = [g if (h or not freeze) else torch.zeros_like(g)
                 for g, h in zip(grads, self.head)]
        if self.accumulate > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            torch._foreach_mul_(self.acc, float(n))
            torch._foreach_add_(self.acc, grads)
            torch._foreach_div_(self.acc, float(n + 1))
            if n + 1 < self.accumulate:
                self.mini_step = n + 1
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
        clip_by_global_norm_(grads, CLIP_NORM)
        torch._foreach_mul_(grads, cosine_scale(self.count, self.decay_steps))
        frozen = [(p, p.clone()) for p, h in zip(self.params, self.head) if freeze and not h]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        for p, before in frozen:
            p.copy_(before)
        self.count += 1
        return True


def batch_loss(model: ResNet, batch: Dict[str, torch.Tensor], args) -> torch.Tensor:
    out = model(batch["image"])
    if args.task == "regress":
        return torch.mean((out - batch["label"].float()) ** 2)
    return focal_ce_loss(out, batch["label"], args.num_classes,
                         gamma=args.focal_gamma if args.loss == "focal" else 0.0,
                         smoothing=args.label_smoothing)


def train_step(model: ResNet, opt: ClassifierOptimizer, batch: Dict[str, torch.Tensor], args,
               freeze: bool) -> torch.Tensor:
    """One micro-batch: the loss in training mode (batch statistics, their
    running averages updated, dropout), its gradients, the optimizer."""
    model.train()
    loss = batch_loss(model, batch, args)
    grads = torch.autograd.grad(loss, opt.params)
    opt.step(list(grads), freeze)
    return loss.detach()


@torch.no_grad()
def eval_outputs(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    model.eval()
    return model(images)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {"image": torch.as_tensor(batch["image"], device=device),
            "label": torch.as_tensor(batch["label"], device=device)}


def build_classifier(args, device) -> ResNet:
    """The ResNet of the flags, its weights drawn from `--seed` as flax's
    init draws them; with `--backbone-params`, that npz's params (its head
    replaced by the drawn one) and batch_stats."""
    cfg = ResNetConfig(variant=args.backbone, num_classes=args.num_classes,
                       head="regress" if args.task == "regress" else "classify",
                       dropout=args.dropout)
    with device:
        model = ResNet(cfg)
    flax_init_(model, torch.Generator(device=device).manual_seed(args.seed))
    if args.backbone_params:
        pretrained = load_params_npz(args.backbone_params)
        own = to_flax_variables(model)
        params = dict(pretrained["params"])
        params[HEAD] = own["params"][HEAD]
        load_variables_(model, {"params": params,
                                "batch_stats": pretrained.get("batch_stats", own["batch_stats"])})
    return model


def save_checkpoint(model: ResNet, path: Path) -> None:
    save_params_npz(to_flax_variables(model), path)


def main(argv=None) -> List[Dict]:
    args = build_argparser().parse_args(argv)
    if args.config:
        args = apply_yaml_config(args, argv)
    device = cli_device(args.device)
    if not args.data_dir:
        raise SystemExit("--data-dir is required (or dataset.data_root via --config)")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = MetricLogger(out_dir / "metrics.jsonl")
    is_reg = args.task == "regress"
    torch.manual_seed(args.seed)  # dropout

    model = build_classifier(args, device)
    train_ds = MESClassificationDataset(args.data_dir, "train", args.image_size,
                                        synthetic_only_train=args.synthetic_only, seed=args.seed)
    val_ds = MESClassificationDataset(args.data_dir, "val", args.image_size, seed=args.seed)
    print(f"train: {len(train_ds)} (counts {train_ds.class_counts.tolist()}), "
          f"val: {len(val_ds)}")

    accum = max(args.accumulate_grad_batches, 1)
    opt = ClassifierOptimizer(
        model, args.optimizer, args.lr, args.weight_decay,
        decay_steps=args.epochs * max(len(train_ds) // args.batch_size // accum, 1),
        accumulate=accum)

    best_metric = np.inf if is_reg else -np.inf
    best_epoch, patience = -1, 0
    history = []
    topk = []  # (monitored metric, epoch, path), best first
    key_metric = "rmse" if is_reg else "qwk"
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        freeze = epoch < args.freeze_backbone_epochs
        for i, batch in enumerate(train_ds.batches(args.batch_size)):
            if args.max_steps_per_epoch and i >= args.max_steps_per_epoch:
                break
            losses.append(float(train_step(model, opt, to_device(batch, device), args, freeze)))

        ys, outs = [], []
        for batch in val_ds.batches(args.batch_size, shuffle=False, drop_last=False):
            out = eval_outputs(model, torch.as_tensor(batch["image"], device=device))
            ys.append(batch["label"])
            outs.append(out.float().cpu().numpy())
        ys, outs = np.concatenate(ys), np.concatenate(outs)
        if is_reg:
            report = regression_report(ys, outs, args.num_classes)
            monitored = -report["rmse"]
            preds = np.clip(np.round(outs.squeeze(-1) if outs.ndim > 1 else outs),
                            0, args.num_classes - 1)
        else:
            probs = torch.softmax(torch.from_numpy(outs), -1).numpy()
            report = classification_report(ys, probs.argmax(1), probs, args.num_classes)
            monitored = report["qwk"]
            preds = probs.argmax(1)
        report["confusion_matrix"] = confusion_matrix(
            ys.astype(int), preds.astype(int), args.num_classes).tolist()
        report["epoch"] = epoch
        report["train_loss"] = float(np.mean(losses)) if losses else 0.0
        report["epoch_seconds"] = time.perf_counter() - t0
        history.append(report)
        logger.log(report)
        print(f"epoch {epoch}: loss={report['train_loss']:.4f} "
              f"{key_metric}={report[key_metric]:.4f}")

        save_checkpoint(model, out_dir / "last.npz")
        if args.save_top_k > 0:
            ckpt_path = out_dir / f"epoch{epoch:03d}.npz"
            save_checkpoint(model, ckpt_path)
            topk.append((monitored, epoch, ckpt_path))
            topk.sort(key=lambda t: -t[0])
            for _, _, evicted in topk[args.save_top_k:]:
                evicted.unlink(missing_ok=True)
            del topk[args.save_top_k:]

        improved = report["rmse"] < best_metric if is_reg else monitored > best_metric
        if improved:
            best_metric = report[key_metric] if is_reg else monitored
            best_epoch, patience = epoch, 0
            save_checkpoint(model, out_dir / "best.npz")
            with open(out_dir / "best_confusion_matrix.json", "w") as f:
                json.dump({"epoch": epoch, "confusion_matrix": report["confusion_matrix"]}, f)
        else:
            patience += 1
            if args.early_stop_patience and patience >= args.early_stop_patience:
                print(f"early stop at epoch {epoch}")
                break

    with open(out_dir / "history.json", "w") as f:
        json.dump(history, f, indent=2)
    print(f"best epoch {best_epoch} ({key_metric}={best_metric:.4f}); kept top-{len(topk)} "
          f"checkpoints {[f'epoch{e:03d}' for _, e, _ in topk]}")
    logger.close()
    return history


if __name__ == "__main__":
    main()
