"""The port's stride quality gate (`scripts/torch_check_stride_quality.py`:
`parse_variant`, the table) and `psd_tpu_torch.utils.fast_init` against
psd_tpu's (`scripts/check_stride_quality.py`, `psd_tpu/utils/fast_init.py`),
on the tiny configuration of `tests/torch_gates.py`, with JAX's draws
handed to the port; and `scripts/check_gate_stability.py` on the port's
tables. Synth-train's batch and LR are tests/test_torch_gate_synth.py, the
int8 gate tests/test_torch_gate_int8.py, the distribution gate
tests/test_torch_gate_distribution.py."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_cli_parity import few_threads
from tests.torch_gates import (ROOT, jax_draws, load_script, printed_json, recorded_fast_init,
                               run_captured, run_jax_main, stride_module, tiny_gates,
                               without_timing)

STRIDE_ARGV = ["--train-steps", "0", "--size", "64", "--batch", "2", "--steps", "3",
               "--variants", "deep2,dpm2"]
# the gates' tables, port against psd_tpu in fp32 compute on the same
# weights and draws (the rows print 6 decimals of a relative error of
# 1e-6..1e-4 and 2 of a PSNR); measured: equal at the printed digits
REL_ERR_RTOL, REL_ERR_ATOL = 5e-2, 2e-6
PSNR_DB_ATOL = 0.5


@pytest.fixture(scope="module")
def stride_runs(tmp_path_factory):
    """psd_tpu's stride gate and the port's on the tiny configuration,
    `STRIDE_ARGV`: psd_tpu's printed JSON, the port's, the port's `--out`
    table and the trees psd_tpu's `fast_init` filled (core, then VAE)."""
    out = tmp_path_factory.mktemp("stride") / "port.json"
    jmod, pmod = load_script("check_stride_quality"), stride_module()
    fills = []
    with pytest.MonkeyPatch.context() as mp, few_threads():
        tiny_gates(mp, pmod)
        jax_draws(mp, pmod)
        recorded_fast_init(mp, fills)
        ref = run_jax_main(jmod, STRIDE_ARGV)
        got = run_captured(pmod.main, STRIDE_ARGV + ["--device", "cpu", "--out", str(out)])
    return {"ref": ref, "got": got, "out": out, "fills": fills}


def _close_rows(got: dict, ref: dict):
    assert list(got) == list(ref)
    for key, want in ref.items():
        if "rel_error" in key:
            np.testing.assert_allclose(got[key], want, rtol=REL_ERR_RTOL, atol=REL_ERR_ATOL,
                                       err_msg=key)
        elif key.endswith("_db"):
            assert abs(got[key] - want) <= PSNR_DB_ATOL, (key, got[key], want)
        else:
            assert got[key] == want, key


def _tokens() -> list:
    """Every variant token psd_tpu's gates and its bench suite name."""
    jmod, jdist = load_script("check_stride_quality"), load_script("check_turbo_distribution")
    lists = [jmod.main.__code__.co_consts, jdist.main.__code__.co_consts]
    suite = (ROOT / "scripts" / "run_bench_suite.sh").read_text()
    found = [c for consts in lists for c in consts
             if isinstance(c, str) and c.startswith(("enc2", "dpm50,", "dpm25,"))]
    found += [line.split('"')[1] for line in suite.splitlines() if "--variants" in line]
    tokens = sorted({t for lst in found for t in lst.split(",")})
    assert {"enc2", "dpm50", "int8", "dpm25+tomeb0.5+deep5", "tomeb0.5+deep6"} <= set(tokens)
    return tokens


def test_parse_variant_is_psd_tpus_on_every_named_token():
    jmod, pmod = load_script("check_stride_quality"), stride_module()
    for tok in _tokens() + ["tome0.25+enc4", "dpm7+int8"]:
        assert pmod.parse_variant(tok) == jmod.parse_variant(tok), tok
    # an unknown token exits; a known one without its number raises
    for bad, error in (("fast3", SystemExit), ("dpm25+x", SystemExit), ("deep", ValueError)):
        with pytest.raises(error):
            jmod.parse_variant(bad)
        with pytest.raises(error):
            pmod.parse_variant(bad)


def test_fast_init_fills_psd_tpus_trees_bit_for_bit(stride_runs, monkeypatch):
    """The core's and the whole AutoencoderKL's fill, each leaf equal to
    the trees psd_tpu's `fast_init` filled in its stride gate."""
    from psd_tpu_torch.diffusion.dadd import DADDCore
    from psd_tpu_torch.models.vae import AutoencoderKL, VAEDecode
    from psd_tpu_torch.utils.fast_init import fast_init

    pmod = stride_module()
    tiny_gates(monkeypatch, pmod)
    want = dict(zip(("core", "vae"), stride_runs["fills"]))
    with torch.device("meta"):
        modules = {"core": DADDCore(pmod.core_config_from(pmod.Config(), remat=False)),
                   "vae": AutoencoderKL(pmod.VAEConfig())}
    for part, module in modules.items():
        got = fast_init(module)
        ref_leaves = jax.tree_util.tree_flatten_with_path(want[part])[0]
        got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
            [jax.tree_util.keystr(p) for p, _ in ref_leaves], part
        for (path, g), (_, r) in zip(got_leaves, ref_leaves):
            assert g.dtype == np.float32 and g.shape == r.shape, jax.tree_util.keystr(path)
            assert np.array_equal(g, r), jax.tree_util.keystr(path)
    # sorted, the tree runs decoder, encoder, post_quant_conv, quant_conv:
    # a walk of the decode half alone draws post_quant_conv where the
    # encoder's leaves are drawn, so a serving model takes the decode half
    # of the whole tree's fill
    with torch.device("meta"):
        alone = fast_init(VAEDecode(pmod.VAEConfig()))["params"]["post_quant_conv"]["kernel"]
    whole = want["vae"]["params"]["post_quant_conv"]["kernel"]
    assert alone.shape == whole.shape and not np.array_equal(alone, whole)


def test_stride_gate_rows_are_psd_tpus(stride_runs):
    """Both gates on fast_init's weights, JAX's cond and x0: the rows, key
    for key and in order, the errors within REL_ERR_* and the PSNRs within
    PSNR_DB_ATOL; the time fields left out."""
    ref, got = stride_runs["ref"], stride_runs["got"]
    assert len(got) == len(ref) == 3
    for g, r in zip(got[:-1], ref[:-1]):
        _close_rows(without_timing(g), without_timing(r))
    tg, tr = without_timing(got[-1]), without_timing(ref[-1])
    assert list(tg) == list(tr) and list(got[-1]) == list(ref[-1])
    for g, r in zip(tg.pop("rows"), tr.pop("rows")):
        _close_rows(g, r)
    assert tg == tr
    assert [r["variant"] for r in got[-1]["rows"]] == ["deep2", "dpm2"]
    assert got[-1]["rows"][1]["latent_rel_error"] > 0


def test_gate_stability_reads_the_ports_tables(stride_runs, tmp_path):
    """`scripts/check_gate_stability.py` (standard library only) reads two
    tables the port wrote and prints its verdict."""
    got, out = stride_runs["got"], stride_runs["out"]
    table = json.loads(out.read_text())
    assert table == got[-1]
    # a second table: the same variants with deep2's PSNR down by 10 dB, a cliff
    other = json.loads(out.read_text())
    other["rows"][0]["psnr_vs_exact_db"] -= 10.0
    (tmp_path / "b.json").write_text(json.dumps(other))
    runs = {}
    for name, paths in (("stable", [out, out]), ("cliff", [out, tmp_path / "b.json"])):
        proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_gate_stability.py"),
                               "--quality", *map(str, paths)], capture_output=True, text=True,
                              cwd=tmp_path, timeout=60)
        runs[name] = (proc.returncode, printed_json(proc.stdout)[-1])
    assert runs["stable"] == (0, {"metric": "gate_ranking_stability", "stable": True,
                                  "n_comparisons": 1})
    assert runs["cliff"] == (1, {"metric": "gate_ranking_stability", "stable": False,
                                 "n_comparisons": 1})
