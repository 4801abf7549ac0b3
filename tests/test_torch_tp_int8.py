"""The int8 UNet under tp (`UNetConfig.quant="int8"` cut by
`parallel/mesh.py::cut_tp_`; `ops/quant.py::qdense(group=, tp=)`) against
the whole int8 UNet and against psd_tpu, on the CPU, fp32.

psd_tpu runs its int8 UNet under `sample(mesh=create_mesh(MeshConfig(dp,
tp=2)))` with the parameters replicated and only the kernels split over
the heads, so `qdense` computes its whole-K function there. The port cuts
the weights, so a row-parallel int8 site (to_out_0, net_2) holds K/tp of
each row's K on each rank; it must compute that same function:

  * per site, on thread ranks of one process (tests/test_torch_tp.py's
    stand-in mesh, the collectives reduced by hand): int8 transformer
    blocks at dims 320 and 512, 8 heads, tp 2 and 4, quantized whole then
    cut. Each row-parallel int8 site, handed its rank's columns of the
    whole site's input, gives the whole site's int32 accumulator and output
    bit for bit (the amax all-reduced MAX, the int32 partials summed: both
    exact); the depth gate reads the whole K (at tp 4, net_2 at dim 320 has
    320 columns a rank and stays int8); the block's output within fp32
    rtol 1e-5 of the whole block's. Two planted faults break the
    bit-equality at every such site: each rank's scale from its own
    columns (no MAX), and a row-parallel weight quantized after the cut;
  * the model, on spawned gloo ranks (tests/torch_dist.py::tp_int8_ranks)
    at (dp 1, tp 2) and (dp 2, tp 2): the wide512 int8 UNet's eps in the
    mesh's tp scope against psd_tpu's int8 UNet on the same parameters, on
    psd_tpu's activation codes (each rank its columns of them at a
    row-parallel site), within 1e-3 relative L2
    (tests/test_torch_unet_int8.py's band: two fp32 implementations flip an
    int8 rounding now and then, and the quantizations after it amplify the
    flip);
  * the plumbing: `GenerationServer(mesh=)` of the tiny int8 model at (dp
    1, tp 2) against the one-process server within atol 1e-4 on images in
    [0, 1], on the one-process run's activation codes (the tp sums' other
    fp32 order flips codes of the resblocks' int8 convs otherwise); every
    rank's images bit-equal.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from psd_tpu.models.unet import UNet2DCondition as JaxUNet
from psd_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.models import layers
from psd_tpu_torch.models.layers import BasicTransformerBlock, CrossAttnMode
from psd_tpu_torch.ops import quant
from psd_tpu_torch.testing import tiny_dadd
from tests.test_torch_tp import _HandSum, _on_thread_ranks, _seeded_
from tests.torch_cli_parity import few_threads
from tests.torch_dist import INT8_GATES, INT8_WIDE, Ranks, tp_int8_ranks
from tests.torch_parity import as_flax, record_psd_tpu

SPLIT3 = dict(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4, num_delta_tokens=4)
MESHES = {"dp1_tp2": 1, "dp2_tp2": 2}
# the eps against psd_tpu's on psd_tpu's activation codes (relative L2)
UNET_INT8_BAND = 1e-3
ROW_PARALLEL = ("to_out_0", "net_2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite's six workers share a few cores (tests/torch_cli_parity.py)
    with few_threads():
        yield


# ---- one block on thread ranks ------------------------------------------------------------
class _Sites:
    """What each int8 site of a run saw, by thread: its input, its int32
    accumulator (the sum over the tp ranks on a cut site) and its output,
    keyed (module name, site name)."""

    def __init__(self, monkeypatch, hand: _HandSum):
        import threading

        self.local = threading.local()
        linear, int_mm = layers.int8_linear, quant.int_mm

        def site_linear(x, module, name, dtype, group=None):
            key = (self.local.names[id(module)], name)
            rec = self.local.record.setdefault(key, {})
            rec["x"], self.local.key = x.clone(), key
            try:
                rec["out"] = linear(x, module, name, dtype, group).clone()
            finally:
                self.local.key = None
            return rec["out"]

        def site_int_mm(xq, wq):
            acc = int_mm(xq, wq)
            if getattr(self.local, "key", None) is not None:
                self.local.record[self.local.key]["acc"] = acc.clone()
            return acc

        def summed(t, total, op):
            key = getattr(self.local, "key", None)
            if key is not None and total.dtype == torch.int32 and op == dist.ReduceOp.SUM:
                self.local.record[key]["acc"] = total.clone()

        hand.local, self.summed = self.local, summed
        monkeypatch.setattr(layers, "int8_linear", site_linear)
        monkeypatch.setattr(quant, "int_mm", site_int_mm)

    def start(self, module) -> dict:
        self.local.names = {id(m): n for n, m in module.named_modules()}
        self.local.record, self.local.seen = {}, self.summed
        return self.local.record


def _int8_block(dim: int):
    block = _seeded_(BasicTransformerBlock(dim, 8, 32, CrossAttnMode("split3", 4, 4, 4),
                                           dtype=torch.float32, quant="int8"), dim)
    return layers.quantize_int8_weights_(block)


def _row_parallel_sites(monkeypatch, dim: int, tp: int, fault=None):
    """The whole int8 block and its tp ranks (threads): → (the row-parallel
    int8 sites' whole records, each rank's records of them, the blocks'
    outputs)."""
    block = _int8_block(dim)
    rng = np.random.default_rng(dim + tp)
    x = torch.from_numpy(rng.standard_normal((2, 64, dim)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))
    hand = _HandSum(tp)
    sites = _Sites(monkeypatch, hand)
    whole_rec = sites.start(block)
    hand.local.rank = 0
    with torch.no_grad():
        whole = block(x, ctx, 0.7, hw=(8, 8))
    whole_rec = {k: v for k, v in whole_rec.items() if k[1] in ROW_PARALLEL and "acc" in v}
    rows = quant.quant_rows
    if fault == "no_max":
        monkeypatch.setattr(quant, "quant_rows", lambda x, group=None: rows(x))

    def rank(b):
        if fault == "quantized_after_cut":
            for m in b.modules():
                for name in set(getattr(m, "int8_sites", ())) & set(ROW_PARALLEL):
                    wq, sw = quant.quant_cols(getattr(m, name).weight, axis=0)
                    getattr(m, f"{name}_wq").copy_(wq)
                    getattr(m, f"{name}_sw").copy_(sw.reshape(-1))
        rec = sites.start(b)
        out = b(x, ctx, 0.7, hw=(8, 8))
        block_rec = dict(rec)
        rec.clear()
        modules = dict(b.named_modules())
        for (mod, name), w in whole_rec.items():
            m = modules[mod]
            k = w["x"].shape[-1] // tp
            r = m.tp.rank
            layers.int8_linear(w["x"][..., r * k:(r + 1) * k], m, name, torch.float32,
                               m.tp.group)
        return out, {k: v for k, v in rec.items()}, block_rec

    outs, _ = _on_thread_ranks(monkeypatch, block, tp, rank, hand)
    return whole_rec, outs, whole


def _mismatches(whole_rec, outs) -> list:
    """The (rank, site) whose accumulator or output differs from the whole
    site's, or that did not take the int8 product."""
    bad = []
    for r, (_, rec, _) in enumerate(outs):
        for key, w in whole_rec.items():
            got = rec.get(key, {})
            if not ("acc" in got and torch.equal(got["acc"], w["acc"])
                    and torch.equal(got["out"], w["out"])):
                bad.append((r, key))
    return bad


@pytest.mark.parametrize("dim,tp", [(320, 2), (320, 4), (512, 2), (512, 4)])
def test_row_parallel_int8_sites_equal_the_whole_sites(monkeypatch, dim, tp):
    """Every row-parallel int8 site on every rank: the whole site's int32
    accumulator and output bit for bit; the int8 row-parallel sites those
    of the whole block (the depth gate at the whole K: net_2 always, to_out_0
    from dim 512 on; at dim 320, tp 4 net_2's 320 columns a rank stay
    int8); the block's output within fp32 rtol 1e-5 of the whole block's,
    every rank's the same, and the block's own sites on the ranks int8
    where the whole block's are."""
    whole_rec, outs, whole = _row_parallel_sites(monkeypatch, dim, tp)
    want = {("ff", "net_2")} | ({("attn1", "to_out_0"), ("attn2", "to_out_0")}
                                if dim >= 512 else set())
    assert set(whole_rec) == want
    assert _mismatches(whole_rec, outs) == []
    for out, _, block_rec in outs:
        np.testing.assert_array_equal(out, outs[0][0])
        assert {k for k, v in block_rec.items() if k[1] in ROW_PARALLEL and "acc" in v} == want
    np.testing.assert_allclose(outs[0][0], whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault", ["no_max", "quantized_after_cut"])
@pytest.mark.parametrize("dim,tp", [(320, 4), (512, 2)])
def test_planted_scale_faults_break_the_equality(monkeypatch, fault, dim, tp):
    """Each planted fault breaks the bit-equality at every row-parallel
    int8 site on every rank: each rank's activation scale from its own K/tp
    columns (quant_rows without the MAX), or a row-parallel weight's int8
    weights and scales quantized from its cut columns."""
    whole_rec, outs, _ = _row_parallel_sites(monkeypatch, dim, tp, fault)
    assert set(_mismatches(whole_rec, outs)) == {(r, k) for r in range(tp) for k in whole_rec}


# ---- the model on gloo ranks ------------------------------------------------------------
def _inputs():
    """tests/test_torch_unet_int8.py's UNet inputs, and six requests for the
    tiny model's servers (two batches at max_batch 4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    req = np.random.default_rng(41).standard_normal((6, 17, 32)).astype(np.float32)
    return {"x": x, "t": t, "ctx": ctx,
            "requests": [(req[i], float(i % 4), 1.0, 5 + i) for i in range(6)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups of ranks started first (they build, quantize and cut the
    model, and run the servers, while psd_tpu records its int8 UNet's eps
    and codes); the records handed over in a file they wait for."""
    inputs = _inputs()
    work = tmp_path_factory.mktemp("tp_int8")
    records = work / "records.pkl"
    ranks = {name: Ranks(tp_int8_ranks, 2 * dp, work, dp, inputs, str(records))
             for name, dp in MESHES.items()}
    kw = dict(INT8_GATES, **INT8_WIDE)
    jmodel = jax_tiny_dadd(**kw, quant="int8")
    core = as_flax(tiny_dadd(seed=2, **kw).core, lambda k: jmodel.init_core(k, 32))
    jm = JaxUNet(jax_tiny_unet(**SPLIT3, **kw, quant="int8"))
    ref, seen = record_psd_tpu(
        lambda p: jm.apply(p, inputs["x"], inputs["t"], inputs["ctx"], jnp.float32(0.5)),
        {"params": core["params"]["unet"]})
    tmp = records.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(seen))
    tmp.rename(records)
    return {"ref": ref, "n_records": len(seen),
            "ranks": {name: r.join() for name, r in ranks.items()}}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(MESHES))
def test_wide512_int8_unet_on_tp_ranks_matches_psd_tpu(runs, name):
    """Every rank's eps (its to_out_0 holding 256 of 512 columns) within
    1e-3 relative L2 of psd_tpu's int8 UNet on its codes, every rank's the
    same; the port's own codes at most 1e-4 of them off psd_tpu's."""
    ranks = runs["ranks"][name]
    for r in ranks:
        assert r["to_out_0_cols"] == 256
        c = r["codes"]
        assert c["calls"] == c["records"] == runs["n_records"]
        assert c["differ"] <= 1e-4 * c["codes"]
        np.testing.assert_array_equal(r["eps"], ranks[0]["eps"])
    rel = _rel(ranks[0]["eps"], runs["ref"])
    print(f"{name}: eps rel L2 {rel:.3e} against psd_tpu on its codes")
    assert np.isfinite(ranks[0]["eps"]).all() and rel <= UNET_INT8_BAND


def test_int8_server_on_tp_ranks_matches_one_process_server(runs):
    """Six requests at max_batch 4 through the tiny int8 model's server at
    (dp 1, tp 2): rank 0's images within atol 1e-4 of the one-process
    server's on its codes, every quantization handed over; the cut model's
    `sample(mesh=)` + `decode_latents(mesh=)` the same on every rank."""
    r0, r1 = runs["ranks"]["dp1_tp2"]
    np.testing.assert_array_equal(r1["images"], r0["images"])
    assert r0["images"].shape == (4, 32, 32, 3)
    got, want = r0["server"], r0["one_process"]
    assert len(got) == len(want) == 6 and r0["server_calls"][0] == r0["server_calls"][1] > 0
    for a, b in zip(got, want):
        assert a.shape == (32, 32, 3) and 0.0 <= a.min() and a.max() <= 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert not np.allclose(got[0], got[4])  # two batches, two seeds
    own = max(np.abs(a - b).max() for a, b in zip(r0["server_own_codes"], want))
    print(f"int8 server at tp 2 on its own codes: max abs {own:.3e} from one process")
