"""The port's training CLI against psd_tpu's, on the CPU at the tiny scale.

`psd_tpu.pipelines.train.main` runs once on a synthetic class-per-directory
tree (configs/tiny_smoke.yaml, batch 4, an epoch of 2 steps, 4 steps, a
validation each epoch on the EMA's weights), its initial parameter trees and
each step's gradients recorded on the way. The port's `main` then runs on the
same tree with those trees bridged in (a patched `build_model`) and JAX's
draws handed over (patched `encode_noise`, `step_draws`, `val_draws`,
`grid_noise`; the embedder noise recorded from flax as in
tests/torch_parity.py). One loader thread: the augment's draws then come in
item order on both sides.

Bands: each logged loss and grad norm, and each val loss, rtol 1e-4; the
final parameters and EMA within the sum over the steps of
`assert_step_parity`'s per-step band (1e-6 + 1e-3·lr, or 2·lr where
psd_tpu's clipped gradient is below 1e-6); the progression grid's pixels
within one uint8 level.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import psd_tpu.diffusion.dadd as jdadd
import psd_tpu.pipelines.train as jtrain
from psd_tpu.convert.io import save_params_npz
from psd_tpu.pipelines.common import build_model as jax_build_model
from psd_tpu_torch.convert.from_jax import to_flax_tree
from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.pipelines import infer
from psd_tpu_torch.pipelines import train
from psd_tpu_torch.train.checkpoint import step_dir
from tests.torch_cli_parity import jax_draws as jax_initial_draws
from tests.torch_parity import jax_draws, leaves, record_aoe_noise

ROOT = Path(__file__).resolve().parents[1]
LR, STEPS = 1e-3, 4
OVERRIDES = ["dataset.batch_size=4", "dataset.num_workers=1", "training.log_every_n_steps=1",
             "training.val_max_batches=1", "training.val_sampling_steps=2",
             "training.update_starting_at_step=0", "training.update_every_n_steps=1",
             "training.noise_offset=0.05", "training.input_perturbation=0.1",
             "model.cfg_drop_prob=0.5", f"optimizer.lr={LR}", "scheduler.warmup_epochs=0"]


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


def _argv(data: Path, out: Path, *extra):
    return ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"),
            f"dataset.dataset_path={data}", *OVERRIDES, "--max-steps", str(STEPS), "--dp", "1",
            "--output-dir", str(out), *extra]


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """psd_tpu's CLI, then the port's on its parameters and draws."""
    tmp = tmp_path_factory.mktemp("train_cli")
    data = _tree(tmp / "data")
    mp = pytest.MonkeyPatch()
    seen = {"grads": []}
    try:
        make_state = jtrain.create_train_state

        def recording_state(*a, **k):
            state, tx = make_state(*a, **k)
            seen["core"] = jax.device_get(state.params)
            return state, tx

        build_optimizer = jtrain.build_optimizer

        def recording_optimizer(*a, **k):
            tx = build_optimizer(*a, **k)

            def update(grads, opt_state, p=None):
                jax.debug.callback(lambda g: seen["grads"].append(jax.device_get(g)), grads)
                return tx.update(grads, opt_state, p)

            return optax.GradientTransformation(tx.init, update)

        encode_latents, encode_clip = jdadd.DADD.encode_latents, jdadd.DADD.encode_image_clip

        def recording_encode(self, vae_params, *a):
            seen.setdefault("vae", jax.device_get(vae_params))
            return encode_latents(self, vae_params, *a)

        def recording_clip(self, clip_params, *a):
            seen.setdefault("clip", jax.device_get(clip_params))
            return encode_clip(self, clip_params, *a)

        mp.setattr(jtrain, "create_train_state", recording_state)
        mp.setattr(jtrain, "build_optimizer", recording_optimizer)
        mp.setattr(jdadd.DADD, "encode_latents", recording_encode)
        mp.setattr(jdadd.DADD, "encode_image_clip", recording_clip)
        jstate = jtrain.main(_argv(data, tmp / "jax"))
        mp.undo()

        cfg = load_config(ROOT / "configs" / "tiny_smoke.yaml", OVERRIDES)
        jm = jax_build_model(cfg)
        seed = cfg.training.seed

        build_model = train.build_model

        def bridged(*a, **k):
            return build_model(*a, **k).load_flax(seen["core"], seen["vae"], seen["clip"])

        def normal(key, shape):
            return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

        def encode_noise(model, images, step):
            shape = (len(images), images.shape[1] // 2, images.shape[2] // 2, 4)
            key = (jax.random.PRNGKey(11) if step is None
                   else jax.random.fold_in(jax.random.PRNGKey(7), step))
            return normal(key, shape)

        def draws(key, shape, step):
            B = shape[0]
            batch = {"latents": np.zeros(shape, np.float32), "labels": np.zeros(B, np.float32),
                     "clip_feats": np.zeros((B, 17, 32), np.float32)}
            d, r_embed = jax_draws(jm, key, batch, step)
            d["aoe_noise"] = record_aoe_noise(jm, seen["core"], batch, d["drop_mask"], r_embed)
            return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

        mp.setattr(train, "build_model", bridged)
        mp.setattr(train, "encode_noise", encode_noise)
        mp.setattr(train, "step_draws", lambda model, state, shape: draws(
            jax.random.PRNGKey(seed + 17), shape, state.step))
        mp.setattr(train, "val_draws", lambda model, shape, i: draws(
            jax.random.PRNGKey(1234), shape, i))
        mp.setattr(train, "grid_noise", lambda model, batch, size: jax_initial_draws(
            99, batch, size // 2, 2, 0.0)[0])
        port = train.main(_argv(data, tmp / "port", "--device", "cpu"))
        yield {"tmp": tmp, "data": data, "jax": jstate, "port": port, "seen": seen, "jm": jm}
    finally:
        mp.undo()


def test_logged_losses_and_grad_norms_match_psd_tpu(runs):
    tmp = runs["tmp"]
    got, want = (_records(tmp / side / "metrics.jsonl") for side in ("port", "jax"))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    steps = [r for r in want if "loss" in r]
    assert [r["step"] for r in steps] == list(range(1, STEPS + 1))
    for a, b in zip(got, want):
        assert a["step"] == b["step"]
        for k in ("loss", "grad_norm", "loss_base", "min_snr_weight_mean", "cfg_drop_rate"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"{k} at {b['step']}")
    assert got[0] == {**want[0], "ts": got[0]["ts"]}  # the routing gates, once


def test_final_params_and_ema_match_psd_tpu(runs):
    """Within the sum over the steps of assert_step_parity's per-step band."""
    jstate, pstate, jm = runs["jax"], runs["port"]["state"], runs["jm"]
    assert pstate.step == int(jstate.step) == STEPS
    assert pstate.ema.count == int(jstate.ema.count) == STEPS
    like = jax.eval_shape(lambda k: jm.init_core(k, 32), jax.random.PRNGKey(0))
    norms = [r["grad_norm"] for r in _records(runs["tmp"] / "jax" / "metrics.jsonl")
             if "grad_norm" in r]
    grads = [dict(leaves(g)) for g in runs["seen"]["grads"]]
    assert len(grads) == len(norms) == STEPS
    lr = 2 * LR  # the larger group's
    jp = dict(leaves(jax.device_get(jstate.params["params"])))
    je = dict(leaves(jax.device_get(jstate.ema.params)))
    pp = dict(leaves(to_flax_tree(dict(pstate.model.core.named_parameters()), like)))
    pe = dict(leaves(to_flax_tree(pstate.ema.params, like)))
    moved = 0
    for name, v in pp.items():
        band = sum(1e-6 + 1e-3 * lr + 2 * lr * (np.abs(g[name] * min(1.0, 1.0 / n)) < 1e-6)
                   for g, n in zip(grads, norms))
        assert np.all(np.abs(v - jp[name]) <= band), name
        assert np.all(np.abs(pe[name] - je[name]) <= band), name
        moved += not np.array_equal(v, dict(leaves(runs["seen"]["core"]["params"]))[name])
    assert moved > len(pp) // 2


def test_validation_matches_psd_tpu(runs):
    """The EMA-swapped val loss of each epoch and its progression grid."""
    tmp = runs["tmp"]
    got, want = ([r for r in _records(tmp / side / "metrics.jsonl") if "val/loss" in r]
                 for side in ("port", "jax"))
    assert [r["epoch"] for r in want] == [r["epoch"] for r in got] == [1, 2]
    for a, b in zip(got, want):
        assert a["val/ema_swapped"] is b["val/ema_swapped"] is True
        np.testing.assert_allclose(a["val/loss"], b["val/loss"], rtol=1e-4)
        grid_a = np.asarray(Image.open(a["val/progression_png"]), np.int16)
        grid_b = np.asarray(Image.open(b["val/progression_png"]), np.int16)
        assert grid_a.shape == grid_b.shape
        assert np.abs(grid_a - grid_b).max() <= 1


def test_checkpoints_and_resume_from_last(runs, tmp_path):
    """Epoch-end checkpoints (steps 2 and 4); "last" resumes at step 4 and
    takes one more step, which the metrics and a fifth checkpoint show."""
    out = runs["tmp"] / "port"
    def steps():
        return sorted(p.name for p in (out / "checkpoints").iterdir() if p.name.isdigit())

    assert steps() == ["2", "4"]
    res = train.main(_argv(runs["data"], out, "--device", "cpu", "--max-steps", "5",
                           "training.resume_checkpoint=last"))
    assert res["state"].step == 5
    assert steps() == ["2", "4", "5"]
    logged = [r["step"] for r in _records(out / "metrics.jsonl") if "loss" in r]
    assert logged == [1, 2, 3, 4, 5]
    meta = json.loads((out / "checkpoints" / "5" / "state.json").read_text())
    assert meta["step"] == 5 and meta["ema_count"] == 5


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_infer_reads_the_ports_checkpoint(runs, tmp_path, monkeypatch, ema):
    """`infer.main --checkpoint <root> [--ema]` equals a run on those weights,
    and takes the VAE and CLIP from the checkpoint's frozen/*.npz."""
    ckpt = runs["tmp"] / "port" / "checkpoints"
    frozen = ckpt / "frozen"
    if not frozen.exists():
        save_params_npz(runs["seen"]["vae"], frozen / "vae.npz")
        save_params_npz(runs["seen"]["clip"], frozen / "clip.npz")
    structure = sorted((runs["data"] / "val" / "Mayo_2").iterdir())[0]
    argv = ["--config", str(ROOT / "configs" / "tiny_smoke.yaml"), "--structure-image",
            str(structure), "--mes-steps", "3", "--sampling-steps", "2", "--image-size", "32",
            "--device", "cpu", "--seed", "5"]
    out = infer.main(argv + ["--checkpoint", str(ckpt), "--output-dir", str(tmp_path / "a")]
                     + (["--ema"] if ema else []))
    latest = step_dir(ckpt)
    assert latest.name == str(max(int(p.name) for p in ckpt.iterdir() if p.name.isdigit()))
    weights = torch.load(latest / ("ema.pt" if ema else "params.pt"), weights_only=True)

    def on_weights(model, checkpoint, use_ema=False):
        model.core.load_state_dict(weights)
        return model.load_flax(vae_tree=runs["seen"]["vae"], clip_tree=runs["seen"]["clip"])

    monkeypatch.setattr(infer, "load_params", on_weights)
    ref = infer.main(argv + ["--output-dir", str(tmp_path / "b")])
    np.testing.assert_array_equal(out["images"], ref["images"])
    assert np.isfinite(out["images"]).all()
    # the run's last checkpoint holds its final state, bit for bit
    state = runs["port"]["state"]
    saved = torch.load(ckpt / str(STEPS) / ("ema.pt" if ema else "params.pt"), weights_only=True)
    final = state.ema.params if ema else dict(state.model.core.named_parameters())
    assert saved.keys() == final.keys()
    assert all(torch.equal(saved[k], t.detach()) for k, t in final.items())


def test_cli_device_and_parallel_refusals(runs, monkeypatch, tmp_path):
    """--device never picks the CPU unasked; without torchrun the world is
    one process, so --dp 2 and --fsdp 2 raise (saying how to start the
    ranks), and --dp 0 is no mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train.build_argparser().parse_args(["--config", "c"]).device == "cuda"
    argv = _argv(runs["data"], tmp_path / "x")
    for extra in ([], ["--device", "auto"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            train.main(argv + extra)
    for extra, match in ((["--dp", "2"], "torchrun --nproc-per-node 2"),
                         (["--fsdp", "2"], "torchrun --nproc-per-node 2"),
                         (["--dp", "0"], "dp is -1 or ≥ 1")):
        with pytest.raises(ValueError, match=match):
            train.main(argv + ["--device", "cpu"] + extra)
    assert not (tmp_path / "x").exists()
