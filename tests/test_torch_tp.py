"""Tensor parallelism for serving (`parallel/mesh.py`: `tp_param_dim`,
`cut_tp_` / `shard_tp_`, `tp_scope`; the tp sites of `models/layers.py`;
`DADD.sample(mesh=)`, `decode_latents(mesh=)` and `GenerationServer(mesh=)`
on (dp, fsdp, tp) meshes) against psd_tpu, on the CPU.

  * Placement: `tp_param_dim` cuts the UNet parameters psd_tpu's
    `tp_param_spec` shards, on the same dim after the (in, out) → (out, in)
    transpose, at the tiny and the SD-scale UNet (`jax.eval_shape` against a
    meta-device model), and `cut_tp_` leaves each rank the shapes that says
    (net_0_proj: each GEGLU half's N/tp rows, psd_tpu's
    `constrain_tp_geglu`).
  * One transformer block (and a UNet for the launches), its tp ranks run as
    threads of one process over a stand-in mesh, the row-parallel partials
    summed by hand in rank order: the ranks' output equals the whole block's
    within fp32 rtol 1e-5 / atol 1e-5 (outputs of order 1: a few ulp of
    the sums' other order), with and without ToMe, and where tp
    does not divide the heads (the attention sites then stay whole).
  * Spawned gloo ranks (tests/torch_dist.py::tp_ranks) at (dp 1, tp 2) and
    (dp 2, tp 2): `sample` + `decode_latents` against psd_tpu's
    `DADD.sample(mesh=create_mesh(MeshConfig(dp, tp=2)))` on conftest's
    virtual CPU devices and its decode, on the same parameters (the port's
    seeded weights in psd_tpu's layout) with JAX's per-sample noise as x0:
    atol 1e-4 on images in [0, 1], the one-process parity band
    (tests/test_torch_generate.py); ToMe in block mode the same way; the
    servers on the ranks against the port's one-process server within
    atol 1e-4 (fp32 partial products summed in another order); every
    rank's images equal bit for bit.
  * What raises under tp: a cut UNet without its mesh, over another tp
    group or reloaded; and what runs there now that training and the int8
    UNet are ported to tp (tests/test_torch_tp_int8.py and
    tests/test_torch_tp_train*.py hold them to psd_tpu).
"""

import copy
import functools
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import UNetConfig as JaxUNetConfig
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from psd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from psd_tpu.parallel.mesh import tp_param_spec
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.convert.from_jax import _leaves, torch_key
from psd_tpu_torch.models import layers
from psd_tpu_torch.models.init import flax_init_
from psd_tpu_torch.models.layers import BasicTransformerBlock, CrossAttnMode
from psd_tpu_torch.models.unet import UNet2DCondition, UNetConfig, tiny_unet_config
from psd_tpu_torch.ops.tome import ToMeSpec
from psd_tpu_torch.parallel import mesh as mesh_mod
from psd_tpu_torch.parallel.mesh import (MeshConfig, TPCut, cut_tp_, shard_tp_, tp_param_dim,
                                         tp_scope)
from psd_tpu_torch.pipelines.serve import GenerationServer
from psd_tpu_torch.testing import route_launches, tiny_dadd
from tests.torch_cli_parity import few_threads, seeded_load_params
from tests.torch_dist import SERVE_TURBO, TINY_TOME_BLOCK, Ranks, tp_ranks

B, STEPS = 4, 4
MESHES = {"dp1_tp2": 1, "dp2_tp2": 2}
SPLIT3 = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite's six workers share a few cores (tests/torch_cli_parity.py)
    with few_threads():
        yield


# ---- placement ---------------------------------------------------------------------
def _configs(config: str):
    """(psd_tpu's, the port's) UNet config, the context's width and length:
    the tiny one or SD scale, split3."""
    if config == "tiny":
        return jax_tiny_unet(**SPLIT3), tiny_unet_config(**SPLIT3), 32, 12
    cfg = UNetConfig(attn_mode="split3")
    return JaxUNetConfig(attn_mode="split3"), cfg, cfg.cross_attention_dim, 48


@functools.lru_cache(maxsize=None)
def _jax_tree(config: str):
    """psd_tpu's UNet tree by jax.eval_shape (no allocation)."""
    jcfg, _, ctx_dim, n_ctx = _configs(config)
    return jax.eval_shape(lambda k: JaxUNet(jcfg).init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, n_ctx, ctx_dim)),
        0.0), jax.random.PRNGKey(0))


def _unet_pair(config: str):
    """(psd_tpu's UNet tree, the port's UNet on the meta device)."""
    with torch.device("meta"):
        return _jax_tree(config), UNet2DCondition(_configs(config)[1])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("config", ["tiny", "sd"])
def test_tp_param_dim_is_tp_param_spec(config, tp):
    """Every UNet parameter: tp_param_dim's dim is tp_param_spec's sharded
    axis transposed (column-parallel P(None, tp) → torch dim 0, row-parallel
    P(tp, None) → dim 1), None where psd_tpu keeps the leaf whole."""
    tree, unet = _unet_pair(config)
    mesh = jax_create_mesh(JaxMeshConfig(dp=1, tp=tp))
    params = dict(unet.named_parameters())
    seen, cut = set(), 0
    for path, leaf in _leaves(tree["params"]):
        key, _ = torch_key(path, len(leaf.shape))
        spec = tp_param_spec("/".join(path), leaf.shape, mesh)
        want = None if spec is None else {(None, "tp"): 0, ("tp", None): 1}[tuple(spec)]
        assert tp_param_dim(key, tuple(params[key].shape), tp) == want, key
        seen.add(key)
        cut += want is not None
    assert seen == set(params)
    # psd_tpu's sites: q, k, v (+ k_dis, v_dis at attn2) and to_out_0 at attn1
    # and attn2, and net_2, in every transformer block
    assert cut == 11 * sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("config", ["tiny", "sd"])
def test_cut_leaves_each_rank_its_slice(config, tp):
    """cut_tp_ on the meta UNet: each weight tp_param_dim names divided by
    tp on that dim, net_0_proj (2N, C) → (2N/tp, C) and its bias (2N/tp,),
    every other parameter (row-parallel biases included) whole, and the
    sites' `tp` set; an attention site whose heads tp does not divide (the
    tiny UNet's 2 at tp 4) stays whole, as psd_tpu's kernels run all its
    heads there (`h_ax = None`)."""
    _, unet = _unet_pair(config)
    whole = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    kept = {name for name, m in unet.named_modules()
            if getattr(m, "tp_kind", None) == "attention" and m.num_heads % tp}
    assert bool(kept) == (config == "tiny" and tp == 4)
    cut = TPCut(object(), tp, tp - 1)
    cut_tp_(unet, cut)
    for key, p in unet.named_parameters():
        shape = list(whole[key])
        dim = tp_param_dim(key, whole[key], tp)
        if key.rsplit(".", 2)[0] in kept:
            pass
        elif dim is not None:
            shape[dim] //= tp
        elif key.endswith("net_0_proj.weight") or key.endswith("net_0_proj.bias"):
            shape[0] //= tp
        assert tuple(p.shape) == tuple(shape), key
    sites = {name: m for name, m in unet.named_modules() if getattr(m, "tp_kind", None)}
    assert sites and all((m.tp is None) == (name in kept) for name, m in sites.items())
    with pytest.raises(RuntimeError, match="already cut"):
        cut_tp_(unet, cut)


def test_net_0_proj_keeps_both_halves_of_the_ranks_columns():
    """A rank's net_0_proj is [h_r ; g_r]: rows r·N/tp..(r+1)·N/tp of each
    GEGLU half of the whole (2N, C) weight and (2N,) bias."""
    C, tp = 8, 2
    ff = layers.GEGLUFeedForward(C, dtype=torch.float32).requires_grad_(False)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.arange(p.numel(), dtype=torch.float32).reshape(p.shape))
    N = 4 * C
    for r in range(tp):
        part = cut_tp_(copy.deepcopy(ff), TPCut(None, tp, r))
        rows = [*range(r * N // tp, (r + 1) * N // tp), *range(N + r * N // tp,
                                                               N + (r + 1) * N // tp)]
        np.testing.assert_array_equal(part.net_0_proj.weight, ff.net_0_proj.weight[rows])
        np.testing.assert_array_equal(part.net_0_proj.bias, ff.net_0_proj.bias[rows])
        np.testing.assert_array_equal(part.net_2.weight,
                                      ff.net_2.weight[:, r * N // tp:(r + 1) * N // tp])
        np.testing.assert_array_equal(part.net_2.bias, ff.net_2.bias)


# ---- the tp ranks as threads of one process ------------------------------------------
class _Mesh:
    """A stand-in for a (dp 1, fsdp 1, tp n) DeviceMesh, as one rank sees
    it, for ranks that are threads of one process."""

    mesh_dim_names = ("dp", "fsdp", "tp")

    def __init__(self, n: int, rank: int, group):
        self.n, self.rank, self.group = n, rank, group

    def size(self, dim=None):
        return self.n if dim is None else (1, 1, self.n)[dim]

    def get_group(self, name):
        return self.group

    def get_local_rank(self, name):
        return self.rank


class _HandSum:
    """`tp_all_reduce` for thread ranks: each rank's partial reduced by hand
    in rank order (the sum, or the max), the same result handed to every
    rank; `seen` records each rank's results by call, for the int8 sites."""

    def __init__(self, n: int):
        self.barrier, self.slots, self.calls = threading.Barrier(n, timeout=60), [None] * n, []
        self.local = threading.local()

    def __call__(self, t, group, op=dist.ReduceOp.SUM):
        r = self.local.rank
        self.slots[r] = t.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for s in self.slots[1:]:
            total = torch.maximum(total, s) if op == dist.ReduceOp.MAX else total + s
        self.barrier.wait()
        self.calls.append(r)
        seen = getattr(self.local, "seen", None)
        if seen is not None:
            seen(t, total, op)
        return t.copy_(total)


def _on_thread_ranks(monkeypatch, module, n: int, fn, hand=None):
    """fn(rank's copy of `module`, cut over tp n as that rank) on n threads,
    each inside tp_scope of its stand-in mesh, the tp collectives reduced by
    hand → (each rank's result, the collectives each rank called)."""
    group, hand = object(), hand or _HandSum(n)
    monkeypatch.setattr(mesh_mod, "tp_all_reduce", hand)
    outs, errors = [None] * n, []

    def rank(r):
        hand.local.rank = r
        mesh = _Mesh(n, r, group)
        try:
            with tp_scope(mesh), torch.no_grad():
                outs[r] = fn(shard_tp_(copy.deepcopy(module), mesh))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            hand.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return outs, Counter(hand.calls)


def _seeded_(module, seed):
    """flax-style init, then every bias and norm parameter drawn too (flax
    starts them at 0 or 1, where a bias added once per rank would pass)."""
    flax_init_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module


@pytest.mark.parametrize("heads,tp,tome", [(4, 2, None), (4, 4, None), (2, 4, None),
                                           (4, 2, "block"), (4, 2, "branch")])
def test_cut_block_on_thread_ranks_equals_the_whole_block(monkeypatch, heads, tp, tome):
    """A split3 transformer block (C = 64, 64 tokens on an 8×8 grid, δ =
    0.7): its tp ranks' output, each rank's the same, against the whole
    block in one process, fp32. Three all-reduces a rank (attn1, attn2,
    net_2), one where tp does not divide the heads (net_2 alone: the
    attention sites stay whole); none in the whole block. ToMe (0.5 at 64
    tokens) merges the same tokens on every rank, the block input being
    the same there."""
    spec = None if tome is None else ToMeSpec(0.5, min_tokens=64, mode=tome, merge_mlp=True)
    block = _seeded_(BasicTransformerBlock(64, heads, 32, CrossAttnMode("split3", 4, 4, 4),
                                           dtype=torch.float32, tome=spec), 3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))
    hand = _HandSum(1)
    monkeypatch.setattr(mesh_mod, "tp_all_reduce", hand)
    with torch.no_grad():
        whole = block(x, ctx, 0.7, hw=(8, 8))
    assert hand.calls == []
    outs, calls = _on_thread_ranks(monkeypatch, block, tp, lambda b: b(x, ctx, 0.7, hw=(8, 8)))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    np.testing.assert_allclose(outs[0], whole, rtol=1e-5, atol=1e-5)
    assert calls == {r: 3 if heads % tp == 0 else 1 for r in range(tp)}


@pytest.mark.parametrize("tp", [2, 4])
def test_route_launches_follow_the_cut(monkeypatch, tp):
    """route_launches(tp=) counts what one rank's cut sites route to the
    kernels (a UNet of 64 and 512 channels, 8 heads, 32² latents, its
    wrappers counted on the CPU, where each runs its plain version), and
    its eps on the thread ranks equals the whole UNet's."""
    outs, whole, want = _cut_unet_launches(monkeypatch, tp, "none")
    np.testing.assert_allclose(outs[0], whole, rtol=1e-5, atol=1e-5)
    assert want["attention"] and want["split3"] and want["ln_proj"] and want["ln_geglu"]


@pytest.mark.parametrize("tp", [2, 4])
def test_route_launches_follow_the_int8_cut(monkeypatch, tp):
    """The same for the int8 UNet, quantized whole then cut: no gn_proj, the
    LayerNorm kernels at the 64-channel level only (the int8 projections
    take the 512 one), at the rank's columns; every rank's eps the same
    (its int8 codes flip against the whole UNet's fp32 sums, so the eps is
    held to psd_tpu's in tests/test_torch_tp_int8.py)."""
    outs, whole, want = _cut_unet_launches(monkeypatch, tp, "int8")
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert bool(torch.isfinite(outs[0]).all()) and outs[0].shape == whole.shape
    assert want["attention"] and want["split3"] and want["ln_proj"] and not want["gn_proj"]


def _cut_unet_launches(monkeypatch, tp: int, quant: str):
    """A UNet of 64 and 512 channels, 8 heads (quantized whole where int8),
    its eps at 32² latents whole and on tp thread ranks, the wrappers
    counted on rank 0: → (the ranks' eps, the whole eps, route_launches(tp=)
    of one evaluation), the counts checked against the routes' and the
    routes at tp against one process's."""
    from psd_tpu_torch.diffusion.dadd import DADDCoreConfig
    from psd_tpu_torch.models.vae import VAEConfig
    from psd_tpu_torch.ops import attention

    seen = Counter()
    lock = threading.Lock()

    def counted(module, attr, name):
        fn = getattr(module, attr)

        def call(*a, **k):
            if getattr(_local, "counting", False):
                with lock:
                    seen[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, attr, call)

    _local = threading.local()
    counted(attention, "attention_fwd", "attention")
    counted(layers, "split3_attention", "split3")
    counted(layers, "ln_proj_fwd", "ln_proj")
    counted(layers, "ln_geglu_fwd", "ln_geglu")
    counted(layers, "gn_proj_fwd", "gn_proj")
    ucfg = tiny_unet_config(**SPLIT3, block_out_channels=(64, 512), num_heads=8, quant=quant)
    unet = layers.quantize_int8_weights_(_seeded_(UNet2DCondition(ucfg), 7))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 12, 32)).astype(np.float32))
    with torch.no_grad():
        whole = unet(x, torch.tensor([300]), ctx, 1.0)

    def eps(u):
        _local.counting = u.down_blocks_0_attentions_0.transformer_blocks_0.attn1.tp.rank == 0
        return u(x, torch.tensor([300]), ctx, 1.0)

    outs, _ = _on_thread_ranks(monkeypatch, unet, tp, eps)
    core_cfg = DADDCoreConfig(unet=ucfg, num_aoe_tokens=4, num_image_tokens=4)
    want = route_launches(core_cfg, VAEConfig(), 1, 256, 1, decode=False, tp=tp)
    assert dict(seen) == {k: v for k, v in want.items() if v}
    assert want == route_launches(core_cfg, VAEConfig(), 1, 256, 1, decode=False)
    return outs, whole.numpy(), want


def test_an_unscoped_or_training_cut_site_raises():
    """A cut block outside tp_scope raises RuntimeError, in training mode
    too; a cut int8 block whose int8 weights were never set from the whole
    weights raises at its first int8 site (quantizing the cut weights would
    give other scales), as does quantizing it after the cut; a tp that does
    not divide the world a ValueError."""
    from psd_tpu_torch.core.mode import training_mode

    block = BasicTransformerBlock(64, 4, 32, dtype=torch.float32)
    cut = cut_tp_(copy.deepcopy(block), TPCut(object(), 2, 0))
    x, ctx = torch.zeros(1, 64, 64), torch.zeros(1, 12, 32)
    with pytest.raises(RuntimeError, match="with no tp mesh"):
        cut(x, ctx)
    with tp_scope(_Mesh(2, 0, object())), pytest.raises(RuntimeError, match="another tp group"):
        cut(x, ctx)
    with training_mode(), pytest.raises(RuntimeError, match="with no tp mesh"):
        cut(x, ctx)
    group = object()
    int8 = cut_tp_(BasicTransformerBlock(512, 8, 32, dtype=torch.float32, quant="int8"),
                   TPCut(group, 2, 0))
    with tp_scope(_Mesh(2, 0, group)), torch.no_grad(), pytest.raises(
            RuntimeError, match="no int8 weights set"):
        int8(torch.zeros(1, 64, 512), ctx)
    with pytest.raises(RuntimeError, match="before the cut"):
        layers.quantize_int8_weights_(int8)
    for cfg, world in ((MeshConfig(tp=3), 2), (MeshConfig(dp=1, tp=2), 4),
                       (MeshConfig(dp=2, fsdp=2, tp=2), 4), (MeshConfig(tp=0), 2)):
        with pytest.raises(ValueError):
            cfg.resolve(world)
    assert MeshConfig(tp=2).resolve(4) == MeshConfig(dp=2, fsdp=1, tp=2)
    assert MeshConfig(fsdp=2, tp=2).resolve(8) == MeshConfig(dp=2, fsdp=2, tp=2)


# ---- spawned gloo ranks against psd_tpu ---------------------------------------------------
def _inputs():
    """The global batch every rank gets: CLIP features, labels, JAX's
    per-sample initial noise, and six requests (two batches at max_batch 4)."""
    rng = np.random.default_rng(37)
    key = jax.random.PRNGKey(43)
    req = rng.standard_normal((6, 17, 32)).astype(np.float32)
    return {"feats": rng.standard_normal((B, 17, 32)).astype(np.float32),
            "tgt": np.array([3.0, 0.5, 2.0, 1.0], np.float32),
            "src": np.array([0.0, 2.0, 1.0, 3.0], np.float32),
            "x0": np.array(jax.random.normal(key, (B, 16, 16, 4), jnp.float32)),
            "requests": [(req[i], float(i % 4), 1.0, 3 + i) for i in range(6)]}, key


def _psd_tpu_images(inputs, key):
    """psd_tpu's sample on each of MESHES (dp, tp 2), and with ToMe in block
    mode at (dp 1, tp 2), then its decode."""
    load, _ = seeded_load_params(tiny_dadd(seed=0))
    core = vae = None
    out = {}
    for name, dp, kw in [(n, dp, {}) for n, dp in MESHES.items()] + [
            ("tome", 1, TINY_TOME_BLOCK)]:
        jm = jax_tiny_dadd(**kw)
        if core is None:
            core, vae, _ = load(jm, None, 0, 32)
        cond = jm.prepare_inference_cond(core, *[jnp.asarray(inputs[k]) for k in
                                                 ("tgt", "src", "feats")])
        lat = jm.sample(core, cond, key, image_size=32, sampling_steps=STEPS, steer_scale=1.0,
                        shared_noise=False, mesh=jax_create_mesh(JaxMeshConfig(dp=dp, tp=2)))
        out[name] = np.asarray(jm.decode_latents(vae, lat))
    return out


def _one_process(inputs):
    """The port in one process: the servers on the same requests, and the
    whole model's eps on the ranks' eps inputs."""
    port = tiny_dadd(seed=0)
    out = {}
    for name, turbo in SERVE_TURBO.items():
        server = GenerationServer(port, image_size=32, sampling_steps=STEPS, max_batch=4,
                                  max_wait_s=0.05, **turbo)
        futures = [server.submit(*r) for r in inputs["requests"]]
        out[name] = [f.result(timeout=300) for f in futures]
        server.close()
    t = {k: torch.from_numpy(inputs[k]) for k in ("tgt", "src", "feats", "x0")}
    cond = port.prepare_inference_cond(t["tgt"], t["src"], t["feats"])
    with torch.no_grad():
        out["eps"] = port.core.eps(t["x0"], torch.full((B,), 500), cond, 1.0).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two groups of ranks started first; psd_tpu's three sharded
    samplers and the port's one process run beside them."""
    inputs, key = _inputs()
    work = tmp_path_factory.mktemp("tp_ranks")
    ranks = {name: Ranks(tp_ranks, 2 * dp, work, inputs, dp) for name, dp in MESHES.items()}
    jax_images = _psd_tpu_images(inputs, key)
    one = _one_process(inputs)
    return {"ranks": {name: r.join() for name, r in ranks.items()}, "jax": jax_images,
            "one": one}


@pytest.mark.parametrize("name", list(MESHES))
def test_sample_on_tp_ranks_matches_psd_tpu(runs, name):
    """Every rank's gathered images equal, bit for bit, and within atol 1e-4
    of psd_tpu's sample on the same mesh shape and its decode; each rank
    holds its half of the heads."""
    ranks = runs["ranks"][name]
    assert ranks[0]["images"].shape == (B, 32, 32, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["images"], ranks[0]["images"])
        assert r["heads"] == 16  # to_q of the 32-channel level: 32 / tp
    np.testing.assert_allclose(ranks[0]["images"], runs["jax"][name], rtol=0, atol=1e-4)


def test_tome_block_mode_on_tp_ranks_matches_psd_tpu(runs):
    """ToMe in block mode at (dp 1, tp 2): the ranks' images equal and
    within atol 1e-4 of psd_tpu's, which differ from the exact path's."""
    r0, r1 = runs["ranks"]["dp1_tp2"]
    np.testing.assert_array_equal(r1["tome"], r0["tome"])
    np.testing.assert_allclose(r0["tome"], runs["jax"]["tome"], rtol=0, atol=1e-4)
    assert np.abs(r0["tome"] - r0["images"]).max() > 1e-3


@pytest.mark.parametrize("name", list(SERVE_TURBO))
def test_server_on_tp_ranks_matches_one_process_server(runs, name):
    """Six requests at max_batch 4 through the server at (dp 1, tp 2):
    rank 0's images within atol 1e-4 of the one-process server's."""
    got, want = runs["ranks"]["dp1_tp2"][0]["servers"][name], runs["one"][name]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert not np.allclose(got[0], got[4])  # two batches, two seeds


def test_eps_in_tp_scope_matches_the_whole_model(runs):
    """core.eps of the cut model inside tp_scope of its mesh, on every rank
    at (dp 2, tp 2), against the whole model's eps (fp32)."""
    for r in runs["ranks"]["dp2_tp2"]:
        np.testing.assert_allclose(r["eps_in_scope"], runs["one"]["eps"], rtol=1e-5, atol=1e-5)


RAISES = {
    "sample without a mesh": "RuntimeError: sample: the UNet is cut over tp",
    "generate": "RuntimeError: generate: the UNet is cut over tp",
    "sample over another tp group": "RuntimeError: the UNet is cut over another tp group",
    "eps without a mesh": "RuntimeError: a UNet cut over tp (2 ranks) runs with no tp mesh",
    "eps over another tp group": "RuntimeError: a UNet cut over tp (2 ranks) runs over another",
    "load_core_state_dict": "RuntimeError: load_core_state_dict: the UNet is cut over tp",
    "load_flax": "RuntimeError: load_flax: the UNet is cut over tp",
}


@pytest.mark.parametrize("case", list(RAISES))
def test_what_raises_under_tp(runs, case):
    """On every rank at (dp 2, tp 2): a cut UNet outside sample(mesh=) of
    its mesh, over another tp group (a second mesh of the same shape) or
    reloaded raises RuntimeError."""
    for r in runs["ranks"]["dp2_tp2"]:
        assert r["other_group"]
        got = r["raises"][case]
        assert got is not None and got.startswith(RAISES[case]), got


RUNS_NOW = ("eps in training", "a training model", "shard_train_state", "the int8 UNet",
            "a server of the int8 UNet")


@pytest.mark.parametrize("case", RUNS_NOW)
def test_what_runs_under_tp(runs, case):
    """On every rank at (dp 2, tp 2), what raised before training and the
    int8 UNet were ported to tp now runs: the cut model's eps in training
    mode (no gradient) equals the whole model's; a training model cuts its
    fp32 masters; `shard_train_state` cuts the UNet and puts the loss under
    DDP over the dp group with the EMA cut alike; the tiny int8 UNet cuts
    and its eps in its tp scope equals its whole eps; a server of it starts
    and closes."""
    for r in runs["ranks"]["dp2_tp2"]:
        got = r["runs"][case]
        if case in ("eps in training", "the int8 UNet"):
            np.testing.assert_allclose(got["cut"], got["whole"], rtol=1e-5, atol=1e-5)
        elif case == "a training model":
            assert got == [16, 32]  # to_q's rows at the 32-channel level: cut, then whole
        elif case == "shard_train_state":
            assert got == {"ddp_ranks": 2, "ema_rows": 16, "param_rows": 16}
        else:
            assert got == "closed"
