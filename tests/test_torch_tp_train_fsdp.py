"""The tp train step with FSDP2 beside tp, and the checkpoints of a tp
train state (`train/checkpoint.py::snapshot` / `restore_into`), on gloo
ranks on the CPU (tests/torch_dist.py). DDP beside tp, the one-process
bands and the planted faults are in tests/test_torch_tp_train.py.

  * four ranks at (dp, fsdp, tp) = (1, 2, 2) against one step of psd_tpu's
    `compile_train_step` on `create_mesh(MeshConfig(dp=1, fsdp=2, tp=2))`:
    FSDP2 on the (dp, fsdp) sub-mesh shards each rank's tp slices too,
    where psd_tpu keeps a tp-cut parameter whole over fsdp (the same
    math); `assert_step_parity` on the gathered step, the clip active;
  * checkpoints at (1, 1, 2): a state that took three one-process steps
    (with accumulation 2: moments and accumulated gradients set), cut onto
    the mesh, snapshots to the one-process state bit for bit (params, EMA,
    both moments, the accumulated gradients, net_0_proj's halves back in
    the one-card order); its checkpoint's files equal the one-card
    checkpoint's bit for bit; a one-card checkpoint restored on the mesh
    and the tp checkpoint restored on one card give states whose tensors,
    gathered whole, equal the saved ones bit for bit; the infer CLI's
    `load_weights` reads the tp checkpoint into a serving model.
"""

import numpy as np
import pytest
import torch

from tests.torch_cli_parity import few_threads
from tests.torch_dist import Ranks, tp_checkpoint_ranks
from tests.torch_parity import OVERRIDES, assert_tp_step_parity, batch_of, psd_tpu_tp_step

ACCUM = {**OVERRIDES, ("training", "accumulate_grad_batches"): 2}
TENSORS = ("params", "ema", "exp_avg", "exp_avg_sq", "acc")
NET_0 = "unet.down_blocks_0_attentions_0.transformer_blocks_0.ff.net_0_proj.weight"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The checkpoint pair and the (1, 2, 2) four started at once,
    psd_tpu's sharded step beside them."""
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    batches = [batch_of(30, 4), batch_of(31, 4), batch_of(32, 4)]
    pair = Ranks(tp_checkpoint_ranks, 2, tmp, str(tmp / "ckpt"), ACCUM, batches)
    with few_threads():  # beside the ranks
        jax_step, like, four, lr = psd_tpu_tp_step(tmp, 1, 2)
    return {"jax": jax_step, "like": like, "lr": lr, "four": four.join(),
            "pair": pair.join(), "ckpt": tmp / "ckpt"}


def test_fsdp2_tp2_ranks_match_psd_tpu_sharded_step(runs):
    """One step of psd_tpu's compile_train_step at (dp 1, fsdp 2, tp 2)
    against the port's four gloo ranks (FSDP2 on the (dp, fsdp) sub-mesh
    beside tp) on the same bridged parameters, rows and JAX's draws: loss
    and metrics, every gradient leaf, the post-step parameters and EMA."""
    assert_tp_step_parity(runs["jax"], runs["like"], runs["four"], runs["lr"])


def _files(directory):
    """A step directory's tensors as TENSORS' dicts of numpy arrays."""
    def load(name):
        return torch.load(directory / name, map_location="cpu", weights_only=True)

    opt = load("optimizer.pt")
    out = {"params": load("params.pt"), "ema": load("ema.pt"), "exp_avg": opt["exp_avg"],
           "exp_avg_sq": opt["exp_avg_sq"], "acc": opt["acc"]}
    return {k: {n: t.numpy() for n, t in v.items()} for k, v in out.items()}, opt


def _equal(got, want, what):
    for k in TENSORS:
        assert set(got[k]) == set(want[k]), (what, k)
        for n, v in want[k].items():
            np.testing.assert_array_equal(got[k][n], v, err_msg=f"{what} {k} {n}")


def test_snapshot_of_a_tp_state_is_the_one_process_state(runs):
    """Rank 0's snapshot of the cut state, gathered over tp, equals the
    state before the cut bit for bit: every tensor, net_0_proj's
    [h_0 h_1 ; g_0 g_1] in the one-card order [h ; g]; the other rank gets
    no copy; moments and accumulated gradients were set."""
    r0, r1 = runs["pair"]
    assert "snapshot" not in r1
    _equal(r0["snapshot"], r0["one_process"], "snapshot")
    assert r0["snapshot"]["params"][NET_0].shape == (256, 32)
    assert all(np.abs(r0["snapshot"][k][NET_0]).max() > 0 for k in TENSORS)


def test_tp_checkpoint_is_the_one_card_checkpoint(runs):
    """The tp state's checkpoint files equal the one-card checkpoint's,
    tensor for tensor, bit for bit, and so do its counts."""
    one, one_opt = _files(runs["ckpt"] / "one" / "3")
    tp, tp_opt = _files(runs["ckpt"] / "tp" / "3")
    _equal(tp, one, "files")
    for k in ("step", "count", "mini_step"):
        assert tp_opt[k] == one_opt[k], k
    assert (one_opt["count"], one_opt["mini_step"]) == (1, 1)


def test_checkpoints_restore_across_the_cut(runs):
    """The one-card checkpoint restored on (1, 1, 2) (every rank), and the
    tp checkpoint restored on one card, each gathered whole, equal the
    saved tensors bit for bit; the counts come back; the infer CLI's
    reading of the tp checkpoint loads into a serving model."""
    saved, _ = _files(runs["ckpt"] / "one" / "3")
    for r in runs["pair"]:
        _equal(r["one_on_tp"], saved, "one-card checkpoint on tp")
        assert r["step_on_tp"] == (3, 1, 1)
    r0 = runs["pair"][0]
    _equal(r0["tp_on_one"], _files(runs["ckpt"] / "tp" / "3")[0], "tp checkpoint on one card")
    assert r0["served_from_tp"]
