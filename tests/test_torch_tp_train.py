"""The tp train step (`train/trainer.py::shard_train_state` and
`make_train_step` on a (dp, fsdp, tp) mesh: the UNet cut over tp, Megatron's
f and g around the cut sites, DDP over the dp group) against psd_tpu's
sharded step and against the port's one-process step, on gloo ranks on the
CPU (tests/torch_dist.py). FSDP2 beside tp and the checkpoints are in
tests/test_torch_tp_train_fsdp.py, so that each psd_tpu mesh sits in a file
of its own.

Bands, with their reasons (tests/test_torch_parallel.py's):
  * four ranks at (dp, fsdp, tp) = (2, 1, 2) against one step of psd_tpu's
    `compile_train_step` on `create_mesh(MeshConfig(dp=2, fsdp=1, tp=2))`
    after its `shard_train_state` (tp-cut transformer kernels), on the same
    bridged parameters, the global batch's rows and JAX's draws:
    `assert_step_parity` (loss and metrics, every gradient leaf gathered
    whole, the post-step parameters and the EMA), the clip active;
  * two ranks at (1, 1, 2) against the port's one-process step on the same
    seeded model, batches and draws, with remat (the recomputation runs
    f and g again): loss and metrics rtol 1e-6; gradients, moments and
    accumulators rtol 1e-5 plus 1e-5 of the largest value; after the first
    optimizer step the parameters and EMA within 1e-6 + 1e-3·lr (2·lr
    where the applied gradient is below 1e-6); after two steps the
    parameters' difference within 1e-3 of the update's norm. The two tp
    ranks end with the same state bit for bit;
  * the planted faults each fail that gradient band: f left off the
    context tokens (the ordinal embedder's, the IP-Plus projection's and
    the purifier's gradients are then a part on each tp rank), and g's
    backward all-reducing too (the residual stream's gradient ×tp).
"""

import numpy as np
import pytest

from tests.torch_cli_parity import few_threads
from tests.torch_dist import Ranks, tiny_runs
from tests.torch_parity import (OVERRIDES, applied_gradient, assert_tp_step_parity, batch_of,
                                close_leaves, psd_tpu_tp_step)

LR = OVERRIDES[("optimizer", "lr")]
ACCUM = {**OVERRIDES, ("training", "accumulate_grad_batches"): 2}
RUNS = {"plain": (OVERRIDES, 2), "accumulate": (ACCUM, 2)}
FAULTS = {"f_off_context": (OVERRIDES, 1, "f_off_context"),
          "g_reducing_backward": (OVERRIDES, 1, "g_reducing_backward")}
CONDITIONING = ("ordinal_embedder", "image_projection", "feature_purifier")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (1, 1, 2) pair (plain, accumulation, the planted faults, with
    remat) and the (2, 1, 2) four started at once, psd_tpu's sharded step
    beside them, then the one-process steps."""
    tmp = tmp_path_factory.mktemp("tp_train")
    batches = [batch_of(20), batch_of(21)]
    pair = Ranks(tiny_runs, 2, tmp, 1, 1, {**RUNS, **FAULTS}, batches, True, 2)
    with few_threads():  # beside the ranks
        jax_step, like, four, lr = psd_tpu_tp_step(tmp, 2, 1)
        one = tiny_runs(None, None, RUNS, batches, True)
    return {"jax": jax_step, "like": like, "lr": lr, "four": four.join(), "one_process": one,
            "pair": pair.join()}


def test_dp2_tp2_ranks_match_psd_tpu_sharded_step(runs):
    """One step of psd_tpu's compile_train_step at (dp 2, fsdp 1, tp 2),
    against the port's four gloo ranks (DDP over the dp group beside tp) on
    the same bridged parameters, the global batch's rows and JAX's draws:
    loss and metrics, every gradient leaf, the post-step parameters and
    the EMA."""
    assert_tp_step_parity(runs["jax"], runs["like"], runs["four"], runs["lr"])


def test_the_ranks_hold_their_slices(runs):
    """Each rank's to_q, to_out_0 and net_0_proj hold their tp slices (half
    of each GEGLU half for net_0_proj)."""
    local = runs["pair"][0]["plain"]["local"]
    site = "unet.down_blocks_0_attentions_0.transformer_blocks_0"
    assert local[f"{site}.attn1.to_q.weight"] == (16, 32)
    assert local[f"{site}.attn1.to_out_0.weight"] == (32, 16)
    assert local[f"{site}.ff.net_0_proj.weight"] == (128, 32)
    assert local[f"{site}.ff.net_2.weight"] == (32, 64)


@pytest.mark.parametrize("run", list(RUNS))
def test_tp_ranks_equal_the_one_process_step(runs, run):
    """(1, 1, 2) with remat: two steps (plain), or two micro-steps of one
    optimizer step (accumulation 2), against the one-process step on the
    global batch: each step's metrics and the first gradient; after the
    first optimizer step the parameters, EMA, moments and counts; after two
    plain steps the parameters' update within 1e-3 of its norm."""
    ref, got = runs["one_process"][run], runs["pair"][0][run]
    assert len(got["metrics"]) == len(ref["metrics"]) == 2
    for gm, rm in zip(got["metrics"], ref["metrics"]):
        assert set(gm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(gm[k], rm[k], rtol=1e-6, err_msg=k)
    close_leaves(got["grads"][0], ref["grads"][0], "gradient")
    i = 1 if run == "accumulate" else 0
    gs, rs, g = got["states"][i], ref["states"][i], applied_gradient(ref, run)
    for what in ("params", "ema"):
        for name, w in rs[what].items():
            band = 1e-6 + 1e-3 * LR + 2 * LR * (np.abs(g[name]) < 1e-6)
            assert np.all(np.abs(gs[what][name] - w) <= band), f"{what} {name}"
    for what in ("exp_avg", "exp_avg_sq"):
        close_leaves(gs[what], rs[what], what)
    assert (gs["count"], gs["ema_count"]) == (rs["count"], rs["ema_count"]) == (1, 1)
    if run == "accumulate":
        close_leaves(got["states"][0]["acc"], ref["states"][0]["acc"], "acc")
        assert got["states"][0]["count"] == 0
    else:
        d = [got["states"][1]["params"][n] - w for n, w in ref["states"][1]["params"].items()]
        u = [w - ref["init"][n] for n, w in ref["states"][1]["params"].items()]
        rel = np.sqrt(sum((x ** 2).sum() for x in d) / sum((x ** 2).sum() for x in u))
        assert rel <= 1e-3, rel


def test_tp_ranks_end_with_one_state(runs):
    """The two tp ranks end with the same parameters, EMA and moments bit
    for bit (each gathered whole: the replicated ones as each rank holds
    them, the cut ones from both ranks' slices), and the same gradients."""
    a, b = (r["plain"] for r in runs["pair"])
    for what in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for name, v in a["states"][-1][what].items():
            np.testing.assert_array_equal(b["states"][-1][what][name], v, err_msg=f"{what} {name}")
    assert all(np.array_equal(a["grads"][0][n], b["grads"][0][n]) for n in a["grads"][0])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_tp_faults_fail_the_parity(runs, fault):
    """Each planted fault fails the gradient band against the one-process
    step: without f on the context tokens the conditioning modules'
    gradients (and no cut parameter's) leave it; with g all-reducing in
    its backward too the cut sites' gradients do, and the norm grows."""
    ref, got = runs["one_process"]["plain"], runs["pair"][0][fault]
    with pytest.raises(AssertionError):
        close_leaves(got["grads"][0], ref["grads"][0], "gradient")
    floor = 1e-5 * max(np.abs(v).max() for v in ref["grads"][0].values())
    off = {n for n, w in ref["grads"][0].items()
           if not np.all(np.abs(got["grads"][0][n] - w) <= 1e-5 * np.abs(w) + floor)}
    cut = set(runs["pair"][0]["plain"]["local"])
    if fault == "f_off_context":
        assert off and all(n.split(".")[0] in CONDITIONING for n in off), sorted(off)
        assert {n.split(".")[0] for n in off} == set(CONDITIONING)
    else:
        assert off & cut
        assert got["metrics"][0]["grad_norm"] > 2 * ref["metrics"][0]["grad_norm"]
