"""The port's train CLI across gloo ranks on the CPU, against its one-process
run (configs/tiny_smoke.yaml on a synthetic tree: a global batch of 4, an
epoch of 2 steps, so step 2 saves and validates on the EMA).

Two ranks at `--dp 2` (DDP) and at `--fsdp 2` (FSDP2) run `main` as
torchrun would start it (tests/torch_dist.py), for 2 steps; rank 0's
checkpoint then holds what the one-process run's does. A one-card
checkpoint resumes at `--fsdp 2` and an `--fsdp 2` checkpoint on one card,
each for a third step, against the one-process resume. The infer CLI reads
rank 0's checkpoint.

Bands (fp32 sums in another order): the logged losses, grad norms and val
loss rtol 1e-6; the counts, steps and generator state equal; the
parameters and EMA after two or three steps within 2e-3 of their distance
from the run's start, the moments within 1e-4 of their norm (relative L2;
read: ≤ 6.4e-4 and ≤ 5.1e-6). Elements whose gradient is rounding noise
flip their Adam step, so no elementwise band holds past the first step;
tests/test_torch_parallel.py holds the first step elementwise.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.parallel.mesh import MeshConfig
from psd_tpu_torch.pipelines import infer, train
from psd_tpu_torch.pipelines.common import build_model
from tests.torch_cli_parity import few_threads
from tests.torch_dist import Ranks, cli_main

ROOT = Path(__file__).resolve().parents[1]
OVERRIDES = ["dataset.num_workers=1", "training.log_every_n_steps=1",
             "training.val_max_batches=1", "training.val_sampling_steps=2",
             "training.update_starting_at_step=0", "training.update_every_n_steps=1",
             "optimizer.lr=1e-3", "scheduler.warmup_epochs=0"]


def _tree(root: Path) -> Path:
    rng = np.random.default_rng(0)
    for split, n in (("train", 2), ("val", 1)):
        for c in range(4):
            d = root / split / f"Mayo_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (72, 64, 3), dtype=np.uint8)).save(
                    d / f"im{i}.png")
    return root


def _argv(data: Path, out: Path, steps: int, *extra):
    return ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"),
            f"dataset.dataset_path={data}", *OVERRIDES, "--max-steps", str(steps),
            "--device", "cpu", "--output-dir", str(out), *extra]


def _ckpt(out: Path, step: int) -> Path:
    return out / "checkpoints" / str(step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, the rank groups started as soon as their inputs exist and
    the one-process runs in this process beside them."""
    tmp = tmp_path_factory.mktemp("parallel_cli")
    data = _tree(tmp / "data")
    out = {k: tmp / k for k in ("one", "dp", "fsdp", "one_to_fsdp", "one_resumed",
                                "fsdp_to_one")}
    dp = Ranks(cli_main, 2, tmp, _argv(data, out["dp"], 2, "--dp", "2"))
    fsdp = Ranks(cli_main, 2, tmp, _argv(data, out["fsdp"], 2, "--fsdp", "2"))
    with few_threads():
        train.main(_argv(data, out["one"], 2))
        resume = f"training.resume_checkpoint={_ckpt(out['one'], 2)}"
        one_to_fsdp = Ranks(cli_main, 2, tmp, _argv(data, out["one_to_fsdp"], 3, resume,
                                                     "--fsdp", "2"))
        train.main(_argv(data, out["one_resumed"], 3, resume))
        ranks = {"dp": dp.join(), "fsdp": fsdp.join()}
        train.main(_argv(data, out["fsdp_to_one"], 3,
                         f"training.resume_checkpoint={_ckpt(out['fsdp'], 2)}"))
    ranks["one_to_fsdp"] = one_to_fsdp.join()
    return {"data": data, "out": out, "ranks": ranks}


def _records(out: Path):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _load(out: Path, step: int):
    d = _ckpt(out, step)

    def load(name):
        return torch.load(d / name, map_location="cpu", weights_only=True)

    opt = load("optimizer.pt")
    return {"params": load("params.pt"), "ema": load("ema.pt"), "exp_avg": opt["exp_avg"],
            "exp_avg_sq": opt["exp_avg_sq"], "opt": opt,
            "meta": json.loads((d / "state.json").read_text())}


def _rel(got, want, start):
    """‖got − want‖ / ‖want − start‖ over every leaf."""
    num = sum(((got[k].double() - want[k].double()) ** 2).sum() for k in want)
    den = sum(((want[k].double() - start[k].double()) ** 2).sum() for k in want)
    return float((num / den).sqrt())


def _start():
    """The parameters every run starts from (the CLI's seeded model)."""
    init = build_model(load_config(ROOT / "configs" / "tiny_smoke.yaml"), device="cpu", seed=0,
                       for_training=True)
    return {k: v.detach() for k, v in init.core.named_parameters()}


def _assert_same_run(got_out: Path, want_out: Path, step: int):
    start = _start()
    got, want = _load(got_out, step), _load(want_out, step)
    assert got["meta"] == want["meta"]  # step, EMA count, the generator's state
    assert (got["opt"]["count"], got["opt"]["mini_step"], got["opt"]["step"]) == \
        (want["opt"]["count"], want["opt"]["mini_step"], want["opt"]["step"])
    zeros = {k: torch.zeros_like(v) for k, v in want["exp_avg"].items()}
    for what, origin in (("params", start), ("ema", start), ("exp_avg", zeros),
                         ("exp_avg_sq", zeros)):
        assert set(got[what]) == set(want[what])
        band = 1e-4 if what.startswith("exp_avg") else 2e-3
        assert _rel(got[what], want[what], origin) <= band, what
    g, w = _records(got_out), _records(want_out)
    assert [r["step"] for r in g] == [r["step"] for r in w]
    for a, b in zip(g, w):
        for k in ("loss", "grad_norm", "val/loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=f"{k} {b['step']}")


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_two_ranks_write_the_one_process_checkpoint(runs, mesh):
    """Rank 0 writes the one-card format: step 2's checkpoint (parameters,
    EMA, moments, counts, generator), the logged losses and grad norms and
    the val loss of the one-process run on the global batch; the other
    rank writes nothing, and every rank ends in the same state."""
    out = runs["out"]
    _assert_same_run(out[mesh], out["one"], 2)
    assert [r["step"] for r in _records(out[mesh]) if "loss" in r] == [1, 2]
    assert any("val/loss" in r for r in _records(out[mesh]))
    assert (out[mesh] / "val_samples" / "epoch0001.png").exists()
    a, b = runs["ranks"][mesh]
    assert a["step"] == b["step"] == 2
    for name, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][name], v, err_msg=name)


def test_checkpoints_resume_across_meshes(runs):
    """A one-card checkpoint resumed at --fsdp 2, and an --fsdp 2 one on one
    card, each for a third step, as the one-process resume."""
    out = runs["out"]
    _assert_same_run(out["one_to_fsdp"], out["one_resumed"], 3)
    _assert_same_run(out["fsdp_to_one"], out["one_resumed"], 3)
    assert runs["ranks"]["one_to_fsdp"][0]["step"] == 3


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_infer_reads_rank_zeros_checkpoint(runs, tmp_path, mesh):
    """The infer CLI reads rank 0's checkpoint (its EMA) as a one-card one."""
    structure = sorted((runs["data"] / "val" / "Mayo_2").iterdir())[0]
    argv = ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"), "--structure-image",
            str(structure), "--mes-steps", "3", "--sampling-steps", "2", "--image-size", "32",
            "--device", "cpu", "--seed", "5", "--ema"]
    with few_threads():
        got = infer.main(argv + ["--checkpoint", str(runs["out"][mesh] / "checkpoints"),
                                 "--output-dir", str(tmp_path / "a")])
        want = infer.main(argv + ["--checkpoint", str(runs["out"]["one"] / "checkpoints"),
                                  "--output-dir", str(tmp_path / "b")])
    assert got["images"].shape == (3, 32, 32, 3) and np.isfinite(got["images"]).all()
    np.testing.assert_allclose(got["images"], want["images"], atol=2 / 255)


@pytest.mark.parametrize("flags,error,match", [
    (["--dp", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--fsdp", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--dp", "2", "--fsdp", "2"], ValueError, "torchrun --nproc-per-node 4"),
])
def test_a_mesh_larger_than_the_world_raises(tmp_path, flags, error, match):
    """Without torchrun the world is one process: a mesh of more ranks
    raises, and says how to start them."""
    with pytest.raises(error, match=match):
        train.main(_argv(tmp_path / "data", tmp_path / "out", 1, *flags))


def test_tp_raises(tmp_path):
    """The train CLI has no --tp, as psd_tpu's has none (`pipelines/train.py:67`
    builds MeshConfig(dp, fsdp)): the tp train step is reached through the
    API (tests/test_torch_tp_train.py); a tp the world does not hold raises
    ValueError."""
    options = {o for a in train.build_argparser()._actions for o in a.option_strings}
    assert {"--dp", "--fsdp"} <= options and "--tp" not in options
    with pytest.raises(SystemExit):
        train.build_argparser().parse_intermixed_args(["--config", "x.yaml", "--tp", "2"])
    for world in (1, 3):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            MeshConfig(dp=1, fsdp=1, tp=2).resolve(world)
