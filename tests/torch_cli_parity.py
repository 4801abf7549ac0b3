"""psd_tpu's CLIs and the port's on the same parameters and draws; shared
by tests/test_torch_clip.py (infer, routing gates), tests/test_torch_infer.py
(infer, baseline mode) and the product-loop CLIs' tests
(tests/test_torch_{augment,evaluate,product_loop}.py).

psd_tpu's `infer.main` runs first, its `load_params` wrapped to record the
parameter trees it draws; the port's `main` then runs on the CPU with
`load_params` bridging those trees in and `initial_draws` returning JAX's
draws (`jax_draws`). The augment factory and the evaluation sweep draw one
latent per image from a key chained batch after batch (`chained_jax_draws`).
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from psd_tpu_torch.pipelines import infer

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_smoke.yaml")


def make_class_tree(root: Path, counts=(("train", 2), ("val", 2), ("test", 1)), size=(64, 64),
                    stem="im", classes=4):
    """A LIMUC-style tree `<split>/Mayo_<c>/<stem><i>.png` (c < `classes`)
    of seeded random RGB images, the same stems in every class."""
    rng = np.random.default_rng(0)
    for split, n in counts:
        for c in range(classes):
            d = root / split / f"Mayo_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
                    d / f"{stem}{i}.png")
    return root


def baseline_config(tmp_path: Path) -> str:
    """configs/tiny_smoke.yaml in baseline mode (no routing gates)."""
    text = Path(TINY).read_text().replace("use_routing_gates: true", "use_routing_gates: false")
    path = tmp_path / "tiny_baseline.yaml"
    path.write_text(text)
    return str(path)


def chained_jax_draws(seed: int, full: int, lat: int):
    """A stand-in for `psd_tpu_torch.pipelines.augment.initial_draws` giving
    psd_tpu's augment and evaluate draws: each run (each new generator)
    starts from PRNGKey(seed); at the batch of job b, key = fold_in(key, b),
    then normal(key, (full, lat, lat, 4)), one latent per image."""
    state = {}

    def draws(model, generator, batch, image_size):
        if state.get("g") is not generator:
            state.update(g=generator, key=jax.random.PRNGKey(seed), b=0)
        state["key"] = jax.random.fold_in(state["key"], state["b"])
        state["b"] += full
        assert batch == full and image_size // model.spatial_factor == lat
        return torch.from_numpy(np.array(
            jax.random.normal(state["key"], (full, lat, lat, 4), jnp.float32)))

    return draws


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


def seeded_load_params(port_model):
    """A stand-in for psd_tpu's `pipelines.infer.load_params` (and the
    evaluate and augment CLIs' import of it) that skips JAX's eager init of
    three models: the port's seeded tiny weights in psd_tpu's layout
    (`jax.eval_shape` of psd_tpu's own init calls), zeros for the VAE
    encoder the port's serving model lacks. Both CLIs then run on these
    trees (the port's through `load_flax`). → (stand-in, the trees)."""
    from psd_tpu_torch.convert.from_jax import _leaves, to_flax_tree, torch_key

    trees = {}

    def as_flax(module, like):
        tensors = dict(module.state_dict())
        for path, leaf in _leaves(like["params"]):
            key, perm = torch_key(path, len(leaf.shape))
            if key not in tensors:
                tensors[key] = torch.zeros(leaf.shape if perm is None else
                                           tuple(leaf.shape[i] for i in perm))
        return {"params": to_flax_tree(tensors, like)}

    def load_params(model, checkpoint, seed, image_size, use_ema=False):
        assert checkpoint is None and not use_ema
        if "core" not in trees:
            key = jax.random.PRNGKey(seed)
            size = model.clip_cfg.image_size
            trees["core"] = as_flax(port_model.core, jax.eval_shape(
                lambda k: model.init_core(k, image_size=image_size), key))
            trees["vae"] = as_flax(port_model.vae, jax.eval_shape(
                lambda k: model.vae.init(k, jnp.zeros((1, image_size, image_size, 3)), k), key))
            trees["clip"] = as_flax(port_model.clip, jax.eval_shape(
                lambda k: model.clip.init(k, jnp.zeros((1, size, size, 3))), key))
        return trees["core"], trees["vae"], trees["clip"]

    return load_params, trees


def port_load_params(trees):
    """The port CLIs' `load_params` bridging `trees` (core, vae, clip)."""
    def load_params(model, checkpoint, use_ema=False):
        assert checkpoint is None and not use_ema
        return model.load_flax(trees["core"], trees["vae"], trees["clip"])

    return load_params


@contextlib.contextmanager
def few_threads(n: int = 2):
    """torch's intra-op threads and the BLAS / OpenMP pools limited to `n`
    for the block. The suite runs six worker processes on a few cores, and
    OpenBLAS's spinning threads (numpy's `eigh` of FID's 2048 × 2048
    covariances) and torch's then starve one another: a test of seconds
    alone took minutes there."""
    from threadpoolctl import threadpool_limits

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        with threadpool_limits(n):
            yield
    finally:
        torch.set_num_threads(before)
