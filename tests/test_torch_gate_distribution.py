"""The port's distribution gate (`scripts/torch_check_turbo_distribution.py`)
against psd_tpu's (`scripts/check_turbo_distribution.py`) on the tiny
configuration of `tests/torch_gates.py`: the port gets psd_tpu's real-init
core and VAE (recorded from its run, bridged) and JAX's draws.

The metric backbones are one seeded stand-in bank on both sides
(`StandInBank`): InceptionV3 at 299² and the CLIP tower through psd_tpu's
jitted FeatureBank took most of three minutes of the file on the CPU, far
over its budget, and `FeatureBank` itself is held to psd_tpu's by
tests/test_torch_evaluate.py. The gates' own arithmetic (the shared
Inception scale, the R + 1 exact sets and their pairwise floor, the signal
check, the rows' mean ± std) runs on the stand-in's features."""

import importlib

import numpy as np
import torch

from psd_tpu_torch.convert.from_jax import state_dict_from_flax
from tests.torch_cli_parity import few_threads
from tests.torch_gates import (jax_draws, load_script, recorded_init, run_captured, run_jax_main,
                               stride_module, tiny_gates, without_timing)

ARGV = ["--train-steps", "0", "--size", "64", "--batch", "2", "--steps", "3", "--images", "4",
        "--repeats", "1", "--variants", "deep2,int8"]
# FID (on the shared scale) and CMMD of the port's sets against psd_tpu's,
# the same weights and draws in fp32 compute; the int8 decoder's
# activation codes may flip apart in a few elements (`tests/torch_gates.py`)
FID_RTOL, FID_ATOL = 2e-2, 1e-4
CMMD_ATOL = 1e-3


class StandInBank:
    """A seeded feature map standing in for FeatureBank's backbones on
    both sides: each image averaged over 8 × 8 pixel blocks and projected
    by a fixed normal matrix through tanh ("inception", 32 features), or
    through another, L2-normalized ("clip", 16)."""

    def __init__(self, *args, **kwargs):
        pass

    @staticmethod
    def features(images, dim: int, seed: int) -> np.ndarray:
        x = np.asarray(images, np.float64)
        B, H, W, C = x.shape
        x = x.reshape(B, 8, H // 8, 8, W // 8, C).mean(axis=(2, 4)).reshape(B, -1)
        proj = np.random.default_rng(seed).standard_normal((x.shape[1], dim))
        return np.tanh(x @ proj / np.sqrt(x.shape[1]))

    def inception(self, images):
        return self.features(images, 32, 0)

    def clip(self, images):
        f = self.features(images, 16, 1)
        return f / np.linalg.norm(f, axis=-1, keepdims=True)


class PortStandInBank(StandInBank):
    """The stand-in with the port's FeatureBank's return type (tensors)."""

    def inception(self, images):
        return torch.from_numpy(super().inception(images)).float()

    def clip(self, images):
        return torch.from_numpy(super().clip(images)).float()


class StubInception:
    """psd_tpu's InceptionV3Features where the stand-in bank replaces it
    (its `init` stands in for the CLIP tower's too)."""

    def __init__(self, *args, **kwargs):
        pass

    def init(self, *args, **kwargs):
        return {}


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.rsplit("/", 1)[-1].startswith("fid"):
        np.testing.assert_allclose(got, want, rtol=FID_RTOL, atol=FID_ATOL, err_msg=path)
    elif isinstance(want, float) and path.rsplit("/", 1)[-1].startswith("cmmd"):
        np.testing.assert_allclose(got, want, rtol=0, atol=CMMD_ATOL, err_msg=path)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=path)
    else:
        assert got == want, path


def test_distribution_gate_is_psd_tpus(monkeypatch):
    """Both gates on psd_tpu's real-init weights and JAX's draws: the
    table, key for key and in order; the floor, the signal and the rows'
    FID and CMMD within FID_* and CMMD_ATOL; gen_s left out."""
    jdadd = importlib.import_module("psd_tpu.diffusion.dadd")
    jvae = importlib.import_module("psd_tpu.models.vae")
    jmod, smod = load_script("check_turbo_distribution"), stride_module()
    pmod = load_script("torch_check_turbo_distribution")
    tiny_gates(monkeypatch, smod, pmod)
    jax_draws(monkeypatch, smod, pmod)
    monkeypatch.setattr(importlib.import_module("psd_tpu.pipelines.evaluate"), "FeatureBank",
                        StandInBank)
    monkeypatch.setattr(importlib.import_module("psd_tpu.models.inception"),
                        "InceptionV3Features", StubInception)
    monkeypatch.setattr(pmod, "FeatureBank", PortStandInBank)
    # psd_tpu's inits of the core (`DADD.init_core`: `core.init`) and the
    # VAE, each one jitted program, recorded; its CLIP tower's parameters
    # go only to the bank the stand-in replaces, so its init is a stub
    cores, vaes = [], []
    recorded_init(monkeypatch, jdadd.DADDCore, cores)
    recorded_init(monkeypatch, jvae.AutoencoderKL, vaes)
    monkeypatch.setattr(importlib.import_module("psd_tpu.models.clip").CLIPVisionTower, "init",
                        StubInception.init)

    def bridged_core(core_cfg, device):
        with torch.device("meta"):
            core = smod.DADDCore(core_cfg)
        return state_dict_from_flax(cores[0], core)

    monkeypatch.setattr(pmod, "real_init_core", bridged_core)
    monkeypatch.setattr(pmod, "real_init_vae", lambda cfg, device: vaes[0])
    with few_threads():
        ref = run_jax_main(jmod, ARGV)
        assert len(cores) == len(vaes) == 1
        got = run_captured(pmod.main, ARGV + ["--device", "cpu"])

    assert [r.get("variant") for r in got[:-1]] == [r.get("variant") for r in ref[:-1]] == \
        ["deep2", "int8"]
    table, want = without_timing(got[-1]), without_timing(ref[-1])
    assert list(got[-1]) == list(ref[-1])
    _close(table, want)
    # the uniform-noise set lies above the floor of two exact sets
    assert table["signal_check_vs_uniform_noise"]["fid"] > table["noise_floor_fresh_seeds"]["fid"]
