"""psd_tpu's quality gates (`scripts/check_{stride_quality,turbo_distribution,
int8_quality}.py`) and the port's (`scripts/torch_check_*.py`) on one tiny
configuration; shared by tests/test_torch_gates.py,
tests/test_torch_gate_int8.py and tests/test_torch_gate_distribution.py.

Both packages' scripts build `Config()`, `core_config_from(cfg, ...)` and
`VAEConfig(...)` inside their main, at SD width. `tiny_gates` patches both
sides to one tiny configuration: `configs/tiny_smoke.yaml`; the tiny UNet
(32, 64 channels) with split3 routing, its cross-attention 768 wide (the
gates' random conditioning is (B, 3N, 768)); a VAE of (32, 128) channels,
so the decoder's mid block and first up block (128 channels) take the
int8 decoder's sites; the tiny CLIP tower. The UNet and the VAE compute
in fp32 where the scripts ask for bf16: at random init the gates measure
differences of 1e-5 of the latents, which the two packages' bf16 roundings
would swamp, while in fp32 they agree to a few percent of them. The
weights are still rounded to bf16 by the scripts, so the int8 codes are
those of the bf16 trees. psd_tpu's `enable_compile_cache` becomes a no-op
(no cache directory is written).

`jax_draws` patches the port's draws (`normal`, `uniform`, `initial_noise`)
with JAX's from the same keys, as `tests/torch_cli_parity.py` hands the
CLIs JAX's draws.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_smoke.yaml")
# the gates' VAE: the decoder's mid block and first up block at 128 channels
GATE_VAE = dict(block_out_channels=(32, 128), layers_per_block=1)
# the keys of the gates' rows that are times (outside the parity)
TIMING = ("exact_s_per_batch", "exact_img_per_s_ex_vae", "s_per_batch", "img_per_s_ex_vae",
          "speedup_vs_exact", "gen_s")


def load_script(name: str):
    """A module of `scripts/` by file name, importable under that name
    (the distribution gates import their stride gate's module)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _core_config(DADDCoreConfig, tiny_unet_config):
    def core_config_from(cfg, remat=None, dtype=None, quant="none", tome_ratio=0.0,
                         tome_mode="branch"):
        # fp32 whatever the script asks (see the module docstring)
        unet = tiny_unet_config(attn_mode="split3", num_aoe_tokens=4, num_image_tokens=4,
                                num_delta_tokens=4, cross_attention_dim=768,
                                remat=bool(remat), quant=quant, tome_ratio=tome_ratio,
                                tome_mode=tome_mode)
        return DADDCoreConfig(unet=unet, embedding_dim=768, conditioning_dim=768,
                              num_classes=cfg.model.ordinal_embedder.num_classes,
                              num_aoe_tokens=4, num_image_tokens=4, purifier_num_heads=2,
                              clip_hidden_dim=32, clip_projection_dim=16)

    return core_config_from


def tiny_gates(monkeypatch, *port_scripts) -> None:
    """Both packages' gates at the tiny configuration (module docstring);
    `port_scripts`, the port's script modules, each patched where it
    looks the names up."""
    # the modules themselves (a package's `__init__` may export a function
    # of the module's name)
    jconfig, jdadd, jvae, jfast = map(importlib.import_module, (
        "psd_tpu.core.config", "psd_tpu.diffusion.dadd", "psd_tpu.models.vae",
        "psd_tpu.utils.fast_init"))
    from psd_tpu.core.config import load_config as jload
    from psd_tpu.models.clip import tiny_clip_config as jclip
    from psd_tpu.models.unet import tiny_unet_config as junet

    pdadd = importlib.import_module("psd_tpu_torch.diffusion.dadd")
    from psd_tpu_torch.core.config import load_config
    from psd_tpu_torch.models.clip import tiny_clip_config as pclip
    from psd_tpu_torch.models.unet import tiny_unet_config as punet
    from psd_tpu_torch.models.vae import VAEConfig as PortVAEConfig

    jcfg = jload(TINY)  # before Config is patched: load_config calls it
    monkeypatch.setattr(jconfig, "Config", lambda: copy.deepcopy(jcfg))
    monkeypatch.setattr(jdadd, "core_config_from", _core_config(jdadd.DADDCoreConfig, junet))
    jvae_cls = jvae.VAEConfig  # before it is patched
    monkeypatch.setattr(jvae, "VAEConfig",
                        lambda **kw: jvae_cls(**dict(kw, **GATE_VAE, dtype=jnp.float32)))
    monkeypatch.setattr(jdadd, "clip_vit_l14_config", lambda **kw: jclip(**kw))
    monkeypatch.setattr(jfast, "enable_compile_cache", lambda *a, **k: None)

    monkeypatch.setattr(pdadd, "clip_vit_l14_config", lambda **kw: pclip(**kw))
    port = dict(Config=lambda: load_config(TINY),
                core_config_from=_core_config(pdadd.DADDCoreConfig, punet),
                VAEConfig=lambda **kw: PortVAEConfig(**dict(kw, **GATE_VAE, dtype=torch.float32)))
    for mod in port_scripts:
        for name, fn in port.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)


def as_torch(x, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def jax_draws(monkeypatch, *port_scripts) -> None:
    """The port's gate draws replaced by JAX's from the same keys, in each
    of `port_scripts` where it looks them up: a normal or uniform draw of a
    shape from PRNGKey(seed), and the initial latents
    `normal(PRNGKey(seed), (B, h, w, 4))` psd_tpu's `sample(...,
    shared_noise=False)` draws."""
    def normal(seed, shape, device):
        return as_torch(jax.random.normal(jax.random.PRNGKey(seed), tuple(shape), jnp.float32),
                        device)

    def uniform(seed, shape, device):
        return as_torch(jax.random.uniform(jax.random.PRNGKey(seed), tuple(shape), jnp.float32),
                        device)

    def initial_noise(model, batch, image_size, seed):
        lat = image_size // model.spatial_factor
        return normal(seed, (batch, lat, lat, model.core_cfg.unet.in_channels), model.device)

    for mod in port_scripts:
        for name, fn in (("normal", normal), ("uniform", uniform),
                         ("initial_noise", initial_noise)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)


def printed_json(text: str) -> list:
    """The JSON objects of the lines of `text` that hold one."""
    return [json.loads(line) for line in map(str.strip, text.splitlines())
            if line.startswith("{")]


def without_timing(obj):
    """A gate's row or table with its time fields taken out."""
    if isinstance(obj, dict):
        return {k: without_timing(v) for k, v in obj.items() if k not in TIMING}
    if isinstance(obj, list):
        return [without_timing(v) for v in obj]
    return obj


def stride_module():
    """The port's stride gate's module (the other gates import it)."""
    return load_script("torch_check_stride_quality")


def run_captured(fn, *args) -> list:
    """`fn(*args)` with its stdout captured → the JSON objects it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return printed_json(out.getvalue())


def run_jax_main(mod, argv) -> list:
    """psd_tpu's script `mod`'s main (it parses sys.argv) under `argv` →
    the JSON objects it printed."""
    saved = sys.argv
    sys.argv = [mod.__name__] + list(argv)
    try:
        return run_captured(mod.main)
    finally:
        sys.argv = saved


def recorded_fast_init(monkeypatch, store: list) -> None:
    """psd_tpu's `fast_init`, recording each tree it fills (numpy leaves)
    in `store`."""
    jfast = importlib.import_module("psd_tpu.utils.fast_init")
    fill = jfast.fast_init

    def recording(*a, **k):
        store.append(jax.tree_util.tree_map(np.asarray, fill(*a, **k)))
        return store[-1]

    monkeypatch.setattr(jfast, "fast_init", recording)


def recorded_init(monkeypatch, module_cls, store: list) -> None:
    """A flax module class's `init`, run as one jitted program (eager, the
    init compiles each of its ops, ~30 s for the tiny core on the CPU) and
    recording the variables it draws (numpy leaves) in `store`; an init
    traced for its shapes (`fast_init`'s `jax.eval_shape`) runs as it is,
    unrecorded."""
    import flax.linen as nn

    def recording(self, *a, **k):
        if any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves((a, k))):
            return nn.Module.init(self, *a, **k)
        out = jax.jit(lambda *args: nn.Module.init(self, *args, **k))(*a)
        store.append(jax.tree_util.tree_map(np.asarray, out))
        return out

    monkeypatch.setattr(module_cls, "init", recording)
