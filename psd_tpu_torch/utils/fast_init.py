"""psd_tpu's `fast_init` fill, without JAX.

`psd_tpu/utils/fast_init.py::fast_init` takes `jax.eval_shape` of a flax
module's init and fills its leaves one after another, in
`jax.tree_util.tree_flatten`'s order (dict keys sorted at every level),
each with `numpy.random.default_rng(seed).standard_normal(shape) * scale`
cast to float32. Here the tree comes from a port module's own parameters,
under the flax names and shapes the bridge maps (`convert/from_jax.py`):
`flax_shapes` is the port's `jax.eval_shape` of the init, and `fast_init`
fills it in the same order from the same generator, so the same seed gives
psd_tpu's leaves bit for bit. `load_flax` / `state_dict_from_flax` take the
tree in. The module must be the one psd_tpu filled: the whole
`AutoencoderKL` for a VAE (psd_tpu's `fast_init(model.vae, ...)` walks the
encoder too, so the decoder's leaves follow the encoder's draws), then
`vae_decode_tree` for a serving model's decoder. psd_tpu's persistent
compile cache (`enable_compile_cache`) is XLA's and has no counterpart.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
from torch import nn


def _flax_leaf(module: nn.Module, name: str, shape) -> tuple:
    """A port tensor's (flax leaf name, flax shape): the inverse of
    `from_jax.torch_key`."""
    shape = tuple(shape)
    if name == "weight" and isinstance(module, nn.Linear):
        return "kernel", (shape[1], shape[0])
    if name == "weight" and isinstance(module, nn.Conv2d):
        return "kernel", (shape[2], shape[3], shape[1], shape[0])  # OIHW → HWIO
    if name == "weight" and isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return "scale", shape
    return name, shape


def flax_shapes(module: nn.Module) -> Dict:
    """`{"params": tree}` in the flax layout of `module`'s state_dict, each
    leaf a zero-stride float32 array of the flax shape (no memory); the
    module may live on the meta device."""
    keys = set(module.state_dict())
    tree: Dict = {}
    for prefix, m in module.named_modules():
        own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        for name, t in own:
            if (f"{prefix}.{name}" if prefix else name) not in keys:
                continue  # a non-persistent buffer (the int8 weights)
            leaf, shape = _flax_leaf(m, name, t.shape)
            node = tree
            for part in prefix.split(".") if prefix else ():
                node = node.setdefault(part, {})
            node[leaf] = np.broadcast_to(np.float32(0), shape)
    return {"params": tree}


def _filled(tree: Mapping, rng: np.random.Generator, scale: float) -> Dict:
    return {k: _filled(tree[k], rng, scale) if isinstance(tree[k], Mapping)
            else (rng.standard_normal(np.shape(tree[k])) * scale).astype(np.float32)
            for k in sorted(tree)}


def fast_init(module: nn.Module, scale: float = 0.02, seed: int = 0) -> Dict:
    """psd_tpu's `fast_init(module, ...)` of the same module: `{"params":
    tree}` of float32 numpy leaves, N(0, scale²) from one numpy generator
    seeded `seed`, drawn leaf by leaf in sorted-key order."""
    return _filled(flax_shapes(module), np.random.default_rng(seed), scale)
