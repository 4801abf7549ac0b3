"""The port's data parallelism (`psd_tpu_torch/parallel/`, the sharded train
step) against psd_tpu's mesh and against its own one-process step, on gloo
ranks on the CPU (tests/torch_dist.py: spawned processes, a file:// store,
two threads and a timeout each).

Bands, with their reasons:
  * the mesh rule, the ranks' rows and the fsdp shard dim: exact;
  * four ranks at (dp, fsdp) = (2, 2) against one step of psd_tpu's
    `compile_train_step` on `create_mesh(MeshConfig(dp=2, fsdp=2))` after
    `shard_train_state`, on the same bridged parameters and JAX's draws:
    tests/test_torch_train.py's bands (`assert_step_parity`: metrics rtol
    1e-5; gradients rtol 2e-4 + atol 2e-6·max|g|; parameters and EMA within
    1e-6 + 1e-3·lr, or 2·lr where the clipped gradient is below 1e-6);
  * (2, 1) and (1, 2) against the port's one-process step on the global
    batch, the same seeded model and draws (fp32 sums in another order):
    loss and metrics rtol 1e-6 each step; gradients, moments and
    accumulators rtol 1e-5 plus 1e-5 of the largest value over all leaves
    (the worst measured 1.8e-6 of it); after the first optimizer step the
    parameters and EMA within test_torch_train.py's band (1e-6 + 1e-3·lr,
    or 2·lr where the applied gradient is below 1e-6: Adam's first step,
    lr·g/(|g| + 1e-8), turns a rounding difference of such a g into up to
    2·lr); after two steps the parameters' difference within 1e-3 of the
    update's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from psd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from psd_tpu.parallel.mesh import fsdp_param_spec
from psd_tpu.parallel.mesh import shard_batch as jax_shard_batch
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import to_flax_tree
from psd_tpu_torch.diffusion.dadd import shard_draws
from psd_tpu_torch.parallel.mesh import MeshConfig, fsdp_shard_dim, rank_device, shard_rows
from psd_tpu_torch.testing import tiny_dadd
from tests.torch_cli_parity import few_threads
from tests.torch_dist import Ranks, steps_and_round_trip, tiny_runs
from tests.torch_parity import (OVERRIDES, applied_gradient, assert_step_parity, close_leaves,
                                configure, jax_draws, jax_sharded_step, record_aoe_noise)

B = 8  # the global batch: 2, 4 or 8 rows a rank
CONFIGS = [(-1, 1), (-1, 2), (-1, 4), (1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4), (8, 1),
           (3, 1), (-1, 3)]


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
            "labels": rng.uniform(0.0, 3.0, B).astype(np.float32),
            "clip_feats": rng.standard_normal((B, 17, 32)).astype(np.float32)}


# ---- the mesh ------------------------------------------------------------------------
@pytest.mark.parametrize("world", range(1, 9))
def test_mesh_config_resolves_as_psd_tpu(world):
    """Where psd_tpu's resolve places every device, the port's gives the
    same mesh; where psd_tpu would leave devices out or fails, it raises."""
    for dp, fsdp in CONFIGS:
        try:
            ref = JaxMeshConfig(dp=dp, fsdp=fsdp).resolve(world)
        except AssertionError:
            ref = None
        if ref is not None and ref.dp >= 1 and ref.dp * ref.fsdp == world:
            got = MeshConfig(dp=dp, fsdp=fsdp).resolve(world)
            assert (got.dp, got.fsdp, got.tp) == (ref.dp, ref.fsdp, 1), (dp, fsdp)
        else:
            with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
                MeshConfig(dp=dp, fsdp=fsdp).resolve(world)


@pytest.mark.parametrize("dp,fsdp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_rank_rows_match_psd_tpu_shard_batch(dp, fsdp):
    """Each mesh position's rows are the rows psd_tpu's `shard_batch` puts on
    that device of conftest's 8-device virtual mesh."""
    mesh = jax_create_mesh(JaxMeshConfig(dp=dp, fsdp=fsdp))
    x = jax_shard_batch(mesh, {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)})["x"]
    index = {s.device: s.index[0] for s in x.addressable_shards}
    for i in range(dp):
        for j in range(fsdp):
            want = index[mesh.devices[i, j, 0]]
            got = shard_rows(16, dp, fsdp, i, j)
            assert (got.start, got.stop) == (want.start, want.stop), (i, j)
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(dp * fsdp + 1, dp, fsdp, 0, 0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_fsdp_shard_dim_is_fsdp_param_spec(n):
    """psd_tpu's rule over the core's parameter shapes (torch layout) and
    edge shapes: the same dim, or None where psd_tpu replicates."""
    mesh = jax_create_mesh(JaxMeshConfig(dp=8 // n, fsdp=n))
    shapes = {tuple(p.shape) for p in tiny_dadd().core.parameters()}
    shapes |= {(), (1,), (3,), (2 * n,), (2 * n - 1, 4 * n), (8, 8), (5, 6, 4)}
    for shape in sorted(shapes):
        spec = tuple(fsdp_param_spec(shape, mesh))
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert fsdp_shard_dim(shape, n) == want, shape


def test_shards_gather_and_cut_as_dtensor(runs):
    """`full` (c10d's all-gather of the padded shards) and `local_part` (a
    whole tensor cut to a shard) agree with DTensor's own sharding on four
    ranks at (2, 2), for even and uneven shapes, on every dim."""
    assert runs["round_trip"] == [[], [], [], []]


def test_tp_raises():
    """A tp that does not divide the world raises, and says how many ranks
    the mesh needs."""
    with pytest.raises(ValueError, match="needs 3 ranks, the world has 2"):
        MeshConfig(tp=3).resolve(2)
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 2"):
        MeshConfig(dp=1, fsdp=2, tp=2).resolve(2)


@pytest.mark.parametrize("local_rank", [0, 1, 2])
def test_rank_device_is_local_rank_card(monkeypatch, local_rank):
    """A rank runs on the card LOCAL_RANK names; a rank the host has no card
    for raises (never two ranks on one card)."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device("cpu") == torch.device("cpu")
    if local_rank < 2:
        assert rank_device("cuda") == torch.device("cuda", local_rank)
    else:
        with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card"):
            rank_device("cuda")


def test_shard_draws_takes_the_rows_of_each_draw():
    """The embedder's noise (2, B, D) splits on dim 1, every other draw on 0."""
    model = tiny_dadd(for_training=True)
    model.cfg.training.noise_offset = model.cfg.training.input_perturbation = 0.1
    draws = model.sample_draws((B, 8, 8, 4), torch.Generator().manual_seed(0))
    part = shard_draws(draws, slice(2, 4))
    assert set(part) == set(draws)
    for k, v in draws.items():
        want = v[:, 2:4] if k == "aoe_noise" else v[2:4]
        torch.testing.assert_close(part[k], want, rtol=0, atol=0)


# ---- the port's ranks against its one-process step ------------------------------------
ACCUM = {**OVERRIDES, ("training", "accumulate_grad_batches"): 2}
RUNS = {"plain": (OVERRIDES, 2), "accumulate": (ACCUM, 2)}
# accumulation under dp = 2 only; both meshes run the plain steps
MESH_RUNS = {(2, 1): RUNS, (1, 2): {"plain": RUNS["plain"]}}
MESHES = list(MESH_RUNS)
LR = OVERRIDES[("optimizer", "lr")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks started at once, psd_tpu's sharded step
    compiled while they run, then the one-process steps: the four ranks on
    JAX's draws (and the shards' round trip), the (2, 1) and (1, 2) pairs
    (with remat). (Ranks started before the JAX work here slow it more
    than they gain.)"""
    jm = jax_tiny_dadd()
    port = tiny_dadd(for_training=True, seed=0)
    configure(jm.cfg, port.cfg)
    batch, key = _batch(11), jax.random.PRNGKey(3)
    like = jax.eval_shape(lambda k: jm.init_core(k, 32), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": to_flax_tree(dict(port.core.named_parameters()), like)})
    draws, r_embed = jax_draws(jm, key, batch)
    draws["aoe_noise"] = record_aoe_noise(jm, params, batch, draws["drop_mask"], r_embed, jit=True)
    tmp = tmp_path_factory.mktemp("ranks")
    four = Ranks(steps_and_round_trip, 4, tmp, 2, 2, OVERRIDES, [batch], 1, False, [draws])
    batches = [_batch(20), _batch(21)]
    pairs = {m: Ranks(tiny_runs, 2, tmp, *m, r, batches, True) for m, r in MESH_RUNS.items()}
    jax_step, like = jax_sharded_step(jm, port, batch, key, JaxMeshConfig(dp=2, fsdp=2))
    with few_threads():  # beside the ranks still running
        one = tiny_runs(None, None, RUNS, batches, True)
    four = four.join()
    return {"jax": jax_step, "like": like, "lr": jm.cfg.optimizer.lr,
            "four": [steps for steps, _ in four], "round_trip": [bad for _, bad in four],
            "one_process": one, **{m: r.join() for m, r in pairs.items()}}


@pytest.fixture(scope="module")
def one_process(runs):
    return runs["one_process"]


@pytest.fixture(params=MESHES, ids=lambda m: f"dp{m[0]}_fsdp{m[1]}")
def ranked(request, runs):
    """The (dp, fsdp) pair's results: by run, each rank's."""
    per_rank = runs[request.param]
    return {run: [r[run] for r in per_rank] for run in MESH_RUNS[request.param]}


# ---- psd_tpu's sharded step ----------------------------------------------------------
def test_four_ranks_match_psd_tpu_sharded_step(runs):
    """One step of psd_tpu's compile_train_step on a (dp=2, fsdp=2) mesh
    with its state fsdp-sharded, against the port's four gloo ranks (HSDP)
    on the same bridged parameters, the global batch's rows and JAX's
    draws: loss and metrics, every gradient leaf, the post-step parameters
    and the EMA."""
    p, like = runs["four"][0], runs["like"]

    def tree(arrays):
        return to_flax_tree({k: torch.from_numpy(v) for k, v in arrays.items()}, like)

    r = {"jax": runs["jax"],
         "port": {"metrics": p["metrics"][0], "grads": tree(p["grads"][0]),
                  "params": tree(p["states"][0]["params"]), "ema": tree(p["states"][0]["ema"]),
                  "ema_count": p["states"][0]["ema_count"], "step": 1},
         "lr": runs["lr"]}
    assert r["jax"]["metrics"]["grad_norm"] > 1.0  # the clip is active
    assert_step_parity(r)
    for q in runs["four"][1:]:  # every rank gathers the same state
        for name, v in p["states"][0]["params"].items():
            np.testing.assert_array_equal(q["states"][0]["params"][name], v, err_msg=name)


@pytest.mark.parametrize("mesh,run", [(m, run) for m, r in MESH_RUNS.items() for run in r],
                         ids=lambda x: f"dp{x[0]}_fsdp{x[1]}" if isinstance(x, tuple) else x)
def test_ranks_equal_the_one_process_step(runs, one_process, mesh, run):
    """Two steps (plain), or two micro-steps of one optimizer step
    (accumulation 2): each step's metrics and the first averaged gradient;
    after the first optimizer step the parameters, EMA, moments and counts
    as the one-process step on the global batch gives them; after two
    plain steps the parameters' update within 1e-3 of its norm (elements
    whose gradient is rounding noise flip their Adam step there, so no
    elementwise band holds past the first step)."""
    ref, got = one_process[run], runs[mesh][0][run]
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


def test_ranks_end_with_one_state(ranked):
    """Ranks given different rows end with the same parameters, EMA and
    moments bit for bit: the gradients were averaged."""
    a, b = ranked["plain"]
    for what in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for name, v in a["states"][-1][what].items():
            np.testing.assert_array_equal(b["states"][-1][what][name], v, err_msg=f"{what} {name}")
    g0, g1 = a["grads"][0], b["grads"][0]
    assert all(np.array_equal(g0[n], g1[n]) for n in g0)


def test_unreached_parameter_gets_a_zero_gradient(ranked, one_process):
    """The embedder's null embedding, which the training loss never reaches,
    has a zero gradient under DDP and FSDP2, as under jax.grad (not None:
    AdamW still steps it, its moments zero), and ends as on one process."""
    name = "ordinal_embedder.null_embedding"
    got, ref = ranked["plain"][0], one_process["plain"]
    for grads in got["grads"]:
        assert grads[name].shape == ref["init"][name].shape and np.all(grads[name] == 0)
    last, want = got["states"][-1], ref["states"][-1]
    assert np.all(last["exp_avg"][name] == 0) and np.all(last["exp_avg_sq"][name] == 0)
    np.testing.assert_array_equal(last["params"][name], want["params"][name])
