"""The port's int8 quality gate (`scripts/torch_check_int8_quality.py`)
against psd_tpu's (`scripts/check_int8_quality.py`), both modes, on the
tiny configuration of `tests/torch_gates.py` with JAX's draws: the printed
rows, and the int8 codes of every model the port built, which must be those
psd_tpu's quantization gives the bf16-cast trees (psd_tpu's gates cast
every fp32 leaf to bf16 before a model sees it and quantize at apply time;
the port quantizes the values it is loaded with, so the gate rounds them to
bf16 first)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from psd_tpu_torch.convert.from_jax import state_dict_from_flax, vae_decode_tree
from tests.torch_cli_parity import few_threads
from tests.torch_gates import (jax_draws, load_script, recorded_fast_init, recorded_init,
                               run_captured, run_jax_main, stride_module, tiny_gates)

INT8_ARGV = ["--size", "64", "--batch", "2", "--steps", "3"]
INT8_VAE_ARGV = ["--vae", "--size", "64", "--batch", "2"]
# the sampling mode's PSNR and max |diff| (at fast_init's weights the
# decoder's images barely move: 120 dB, the clamp of an MSE of 0, on both)
PSNR_DB_ATOL, MAX_DIFF_ATOL = 0.5, 1e-3
# the decode mode's PSNR (about 44-46 dB at the tiny VAE): the two
# packages' bf16 decoders round differently, so their int8 errors are
# close, not equal
INT8_VAE_PSNR_DB_ATOL = 3.0


def _reference_codes(port_module, tree) -> dict:
    """psd_tpu's int8 weight codes and scales (`ops/quant.py::quant_cols`
    of each kernel cast to bf16, as psd_tpu's gates cast their trees) for
    every int8 site of `port_module` ({state_dict prefix: (codes in the
    port's layout, scales)})."""
    from psd_tpu.ops.quant import quant_cols as jax_quant_cols

    scales = {}
    # one program a kernel shape (eager, each op compiles for each shape)
    quant_bf16 = jax.jit(lambda w: jax_quant_cols(w.astype(jnp.bfloat16), axis=-1))

    def site_codes(path, leaf):
        if path[-1].key != "kernel":
            return leaf
        q, s = quant_bf16(jnp.asarray(leaf))
        scales[".".join(p.key for p in path[:-1])] = np.asarray(s).reshape(-1)
        return np.asarray(q, np.float32)

    sd = state_dict_from_flax(jax.tree_util.tree_map_with_path(site_codes, tree), port_module)
    out = {}
    for prefix, m in port_module.named_modules():
        for name in getattr(m, "int8_sites", ()):
            key = f"{prefix}.{name}" if prefix else name
            out[key] = (sd[f"{key}.weight"].reshape(getattr(m, f"{name}_wq").shape), scales[key])
    return out


def _check_codes(port_module, tree) -> int:
    """The port's int8 buffers equal psd_tpu's codes of the bf16 tree;
    → the number of sites."""
    sites = _reference_codes(port_module, tree)
    assert sites
    for prefix, m in port_module.named_modules():
        for name in getattr(m, "int8_sites", ()):
            key = f"{prefix}.{name}" if prefix else name
            want_q, want_s = sites[key]
            assert torch.equal(getattr(m, f"{name}_wq").float(), want_q), key
            assert np.array_equal(getattr(m, f"{name}_sw").numpy(), want_s), key
    return len(sites)


def test_int8_gate_is_psd_tpus_and_quantizes_the_bf16_trees(monkeypatch):
    """Both modes of both int8 gates on the same weights and draws: the
    printed rows (PSNR within the stated tolerance) and, in each model the
    port built, the int8 codes and scales psd_tpu's quantization gives the
    bf16-cast trees, bit for bit."""
    import psd_tpu.models.vae as jvae

    jmod, smod = load_script("check_int8_quality"), stride_module()
    pmod = load_script("torch_check_int8_quality")
    tiny_gates(monkeypatch, smod, pmod)
    jax_draws(monkeypatch, smod, pmod)
    fills, vae_inits = [], []
    recorded_fast_init(monkeypatch, fills)
    recorded_init(monkeypatch, jvae.AutoencoderKL, vae_inits)
    with few_threads():
        ref = run_jax_main(jmod, INT8_ARGV)
        models = []
        got = run_captured(pmod.main, INT8_ARGV + ["--device", "cpu"], models)
        # the decode mode on psd_tpu's own decoder weights
        ref_vae = run_jax_main(jmod, INT8_VAE_ARGV)
        assert len(vae_inits) == 1
        monkeypatch.setattr(pmod, "real_init_vae", lambda cfg, device: vae_inits[0])
        decoders = []
        got_vae = run_captured(pmod.main, INT8_VAE_ARGV + ["--device", "cpu"], decoders)

    assert len(got) == len(ref) == 1 and list(got[0]) == list(ref[0])
    assert abs(got[0].pop("value") - ref[0].pop("value")) <= PSNR_DB_ATOL
    assert abs(got[0].pop("max_abs_diff") - ref[0].pop("max_abs_diff")) <= MAX_DIFF_ATOL
    assert got[0] == ref[0]
    assert len(got_vae) == len(ref_vae) == 1 and list(got_vae[0]) == list(ref_vae[0])
    assert abs(got_vae[0].pop("value") - ref_vae[0].pop("value")) <= INT8_VAE_PSNR_DB_ATOL
    got_vae[0].pop("max_abs_diff"), ref_vae[0].pop("max_abs_diff")
    assert got_vae[0] == ref_vae[0]

    # the codes: the int8 UNet's (from the core's fill) and the int8
    # decoder's (from psd_tpu's decoder init), each of the bf16 tree
    core_fill = fills[0]["params"]
    int8_model = models[1]
    assert int8_model.core_cfg.unet.quant == "int8"
    assert _check_codes(int8_model.core, core_fill) > 0
    int8_decoder = decoders[1]
    assert int8_decoder.config.quant == "int8"
    assert _check_codes(int8_decoder, vae_decode_tree(vae_inits[0])) > 0
