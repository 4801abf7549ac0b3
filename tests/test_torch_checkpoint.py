"""The port's checkpoints and the training CLI's small modules against
psd_tpu, on the CPU.

  * `train/checkpoint.py`: a save/restore round trip bit for bit (the
    parameters, AdamW's moments and step counts, the optimizer count and
    accumulation, the EMA and the draws' generator) through `restore_into`
    and `step_dir`, the CLI's path; `MAX_TO_KEEP`, `latest_step`, and
    `resolve_resume_path` against psd_tpu's.
  * `embedding_stats` and `MetricLogger` against psd_tpu's.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu.train.checkpoint import resolve_resume_path as jax_resolve_resume_path
from psd_tpu.utils.logging import MetricLogger as JaxMetricLogger
from psd_tpu_torch.convert.from_jax import to_flax_tree
from psd_tpu_torch.testing import tiny_dadd
from psd_tpu_torch.train import (CheckpointManager, create_train_state, load_weights,
                                 make_train_step, resolve_resume_path)
from psd_tpu_torch.train.checkpoint import FILES, MAX_TO_KEEP, restore_into, step_dir
from psd_tpu_torch.utils.logging import MetricLogger
from tests.torch_parity import configure


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
            "labels": np.array([0.0, 2.5, 1.0, 3.0][:B], np.float32),
            "clip_feats": rng.standard_normal((B, 17, 32)).astype(np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _trained(seed, steps, accumulate=1):
    """A tiny model's train state after `steps` steps on seeded batches."""
    model = tiny_dadd(for_training=True, seed=seed)
    configure(model.cfg)
    model.cfg.training.accumulate_grad_batches = accumulate
    state, tx = create_train_state(model, steps_per_epoch=4, seed=seed + 10)
    step = make_train_step(model, tx)
    for i in range(steps):
        state, _ = step(state, _tbatch(_batch(i)))
    return state, step


def _assert_states_equal(a, b):
    pa, pb = dict(a.model.core.named_parameters()), dict(b.model.core.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        sa, sb = a.opt_state.adamw.state[pa[name]], b.opt_state.adamw.state[pb[name]]
        assert sa.keys() == sb.keys(), name
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.mini_step, a.step, a.ema.count) == (ob.count, ob.mini_step, b.step,
                                                             b.ema.count)
    assert (oa.acc is None) == (ob.acc is None)
    for x, y in zip(oa.acc or [], ob.acc or []):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("accumulate,steps", [(1, 1), (2, 3)], ids=["plain", "accumulating"])
def test_save_restore_round_trip_is_bit_exact(tmp_path, accumulate, steps):
    """Everything a step reads comes back equal, into a state of other
    weights and draws; the next step then agrees bit for bit too."""
    state, step = _trained(0, steps, accumulate)
    if accumulate > 1:
        assert state.opt_state.mini_step == 1 and state.opt_state.acc is not None
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.save(steps, state)
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "ckpt" / str(steps)).iterdir()) == sorted(FILES)
    meta = json.loads((tmp_path / "ckpt" / str(steps) / "state.json").read_text())
    assert meta["step"] == steps and meta["ema_count"] == state.ema.count
    weights = load_weights(tmp_path / "ckpt", ema=True)
    assert weights.keys() == state.ema.params.keys()
    assert all(torch.equal(weights[k], v) for k, v in state.ema.params.items())
    other, other_step = _trained(7, 1, accumulate)
    restore_into(other, step_dir(tmp_path / "ckpt"))
    _assert_states_equal(state, other)
    batch = _tbatch(_batch(9))
    (_, ma), (_, mb) = step(state, batch), other_step(other, batch)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    _assert_states_equal(state, other)


def test_max_to_keep_and_latest_step(tmp_path):
    """The newest MAX_TO_KEEP steps stay; a step is saved once; a step
    being written (`<step>.tmp`) is not one; `step_dir` takes a root to its
    latest step and raises where there is none."""
    state, _ = _trained(0, 0)
    (tmp_path / "9.tmp").mkdir()
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        step_dir(tmp_path)
    assert mgr.save(2, state) and not mgr.save(2, state)
    for s in (3, 4, 6):
        assert mgr.save(s, state)
    mgr.wait()
    assert MAX_TO_KEEP == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4", "6", "9.tmp"]
    assert mgr.latest_step() == 6 == CheckpointManager(tmp_path).latest_step()
    assert step_dir(tmp_path) == tmp_path / "6" and step_dir(tmp_path / "4") == tmp_path / "4"
    with pytest.raises(FileNotFoundError):
        step_dir(tmp_path / "missing")


@pytest.mark.parametrize("resume", [None, "", "last", "last-missing", "step", "missing"])
def test_resolve_resume_path_matches_psd_tpu(tmp_path, resume):
    root = tmp_path / "checkpoints"
    (root / "4").mkdir(parents=True)
    arg = {"last-missing": "last", "step": str(root / "4"),
           "missing": str(tmp_path / "nowhere")}.get(resume, resume)
    ckpt_root = tmp_path / "none" if resume == "last-missing" else root
    if resume in ("last-missing", "missing"):
        for fn in (resolve_resume_path, jax_resolve_resume_path):
            with pytest.raises(FileNotFoundError):
                fn(arg, ckpt_root)
        return
    assert resolve_resume_path(arg, ckpt_root) == jax_resolve_resume_path(arg, ckpt_root)


def test_embedding_stats_match_psd_tpu():
    jm, port = jax_tiny_dadd(), tiny_dadd(seed=2)
    like = jax.eval_shape(lambda k: jm.init_core(k, 32), jax.random.PRNGKey(0))
    params = {"params": to_flax_tree(dict(port.core.named_parameters()), like)}
    ref = jm.core.apply(params, method=lambda m: m.ordinal_embedder.embedding_stats())
    got = port.core.ordinal_embedder.embedding_stats()
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_metric_logger_records_match_psd_tpu(tmp_path):
    records = [{"step": 0, "gates/anatomy_anat": 0.1}, {"step": 1, "loss": 0.25, "x": [1, 2]}]
    for cls, name in ((MetricLogger, "port"), (JaxMetricLogger, "jax")):
        log = cls(tmp_path / name / "metrics.jsonl", wandb_cfg={"project": None})
        for r in records:
            log.log(r)
        log.close()
    got, want = ([json.loads(line) for line in (tmp_path / n / "metrics.jsonl").read_text()
                  .splitlines()] for n in ("port", "jax"))
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == records
    assert all(isinstance(r["ts"], float) for r in got)
    again = MetricLogger(tmp_path / "port" / "metrics.jsonl")  # appends
    again.log({"step": 2})
    again.close()
    assert len(Path(tmp_path / "port" / "metrics.jsonl").read_text().splitlines()) == 3
