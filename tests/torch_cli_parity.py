"""psd_tpu's infer CLI and the port's on the same parameters and draws;
shared by tests/test_torch_clip.py (routing gates) and
tests/test_torch_infer.py (baseline mode).

psd_tpu's `infer.main` runs first, its `load_params` wrapped to record the
parameter trees it draws; the port's `main` then runs on the CPU with
`load_params` bridging those trees in and `initial_draws` returning JAX's
draws (`jax_draws`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from psd_tpu_torch.pipelines import infer


def jax_draws(seed: int, batch: int, lat: int, steps: int, eta: float):
    """psd_tpu infer.main's draws: the shared initial latent from
    PRNGKey(seed) (dadd.py:483-485) and, for eta > 0, the DDIM noise of
    each key of split(fold_in(key, 1), steps) (sampler.py:64-68, :141)."""
    key = jax.random.PRNGKey(seed)
    x0 = np.tile(np.asarray(jax.random.normal(key, (1, lat, lat, 4), jnp.float32)),
                 (batch, 1, 1, 1))
    if eta <= 0:
        return torch.from_numpy(x0), None
    keys = jax.random.split(jax.random.fold_in(key, 1), steps)
    noise = np.stack([np.asarray(jax.random.normal(k, (batch, lat, lat, 4), jnp.float32))
                      for k in keys])
    return torch.from_numpy(x0), torch.from_numpy(noise)


def run_both(monkeypatch, tmp_path, argv, lat: int, steps: int, eta: float = 0.0):
    """psd_tpu's infer.main, then the port's with psd_tpu's parameters and
    draws; returns (jax result, port result)."""
    import psd_tpu.pipelines.infer as jinfer

    seen = {}
    jax_load_params = jinfer.load_params

    def recording(*a, **k):
        seen["trees"] = jax.device_get(jax_load_params(*a, **k))
        return seen["trees"]

    monkeypatch.setattr(jinfer, "load_params", recording)
    ref = jinfer.main(argv + ["--output-dir", str(tmp_path / "jax")])

    def bridged(model, checkpoint, use_ema=False):
        assert checkpoint is None and not use_ema
        return model.load_flax(*seen["trees"])

    n = ref["images"].shape[0]
    seed = int(argv[argv.index("--seed") + 1])
    monkeypatch.setattr(infer, "load_params", bridged)
    monkeypatch.setattr(infer, "initial_draws",
                        lambda model, *a: jax_draws(seed, n, lat, steps, eta))
    out = infer.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    return ref, out


def check_outputs(ref, out, tmp_path):
    assert out["images"].shape == ref["images"].shape
    assert np.isfinite(out["images"]).all()
    assert out["images"].min() >= 0.0 and out["images"].max() <= 1.0
    np.testing.assert_allclose(out["images"], np.asarray(ref["images"]), rtol=0, atol=1e-4)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir() if p.name != "trace")
    assert [Path(p).name for p in out["paths"]] == [Path(p).name for p in ref["paths"]]
    assert {"progression_grid.png", "structure_reference.png"} <= set(names)
    assert set(out["phases"]) == {"clip_encode", "prepare_cond", "generate"}
