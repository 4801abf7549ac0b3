"""Bridge from `psd_tpu`'s parameter trees to the port's state_dicts.

Input: the flax tree as nested dicts of numpy arrays, the form
`psd_tpu/convert/io.py` writes to npz (`load_params_npz` returns it; a
`{"params": ...}` wrapper is accepted). The port's module names are the flax
names, so the walk is mechanical:

  * Dense `kernel` (in, out)  → Linear `weight` (out, in);
  * Conv `kernel` HWIO        → Conv2d `weight` OIHW;
  * LayerNorm/GroupNorm `scale` → `weight`;
  * `bias` and free parameters (`base`, `deltas`, `null_embedding`,
    `latents`, the BOE's `table`, CLIP's `class_embedding` and
    `position_embedding`) keep their name and shape.

The CLIP tower's patch embedding is a Conv (HWIO → OIHW) like any other.

Every leaf must land on a port parameter of the same shape and every port
parameter must be filled, or the bridge raises. A training model's VAE
(`AutoencoderKL`) takes the whole VAE tree; a serving model's decoder its
decode half (`vae_decode_tree`). `to_flax_tree` walks the other way, from
port tensors into the layout of a given flax tree (the train-step tests
hold post-step parameters and the EMA against psd_tpu's).

The backbones with BatchNorm (`models/{inception,vgg,resnet}.py`) take
flax's whole `{"params", "batch_stats"}` variables (`load_variables_`): the
BatchNorm's running `mean` and `var` keep their names, as the port's
`models/batchnorm.py` buffers. `to_flax_variables` writes a module back
into that layout with no tree to follow (the classifier's npz checkpoints,
which psd_tpu reads). Real checkpoints reach this through the one name map that exists:
diffusers → `psd_tpu/convert/sd.py` (`scripts/port_weights.py`) → npz
(`convert/npz.py`) → here.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# the VAE subtrees a serving model's decoder holds
VAE_DECODE_KEYS = ("decoder", "post_quant_conv")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def torch_key(path: Tuple[str, ...], ndim: int) -> Tuple[str, Tuple[int, ...] | None]:
    """(flax leaf path, leaf ndim) → (state_dict key, axis permutation)."""
    *mods, leaf = path
    if leaf == "kernel":
        if ndim == 2:
            return ".".join(mods + ["weight"]), (1, 0)
        if ndim == 4:
            return ".".join(mods + ["weight"]), (3, 2, 0, 1)
        raise ValueError(f"kernel of rank {ndim} at {'/'.join(path)}")
    if leaf == "scale":
        return ".".join(mods + ["weight"]), None
    return ".".join(path), None


def _unwrap(tree: Mapping) -> Mapping:
    return tree["params"] if set(tree) == {"params"} else tree


def state_dict_from_flax(tree: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a flax tree into a state_dict for `module`; strict both ways."""
    target = {k: v.shape for k, v in module.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(_unwrap(tree)):
        arr = np.asarray(leaf)
        key, perm = torch_key(path, arr.ndim)
        if perm is not None:
            arr = arr.transpose(perm)
        if key not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} → {key}: no such port parameter")
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        if tuple(arr.shape) != tuple(target[key]):
            raise ValueError(f"{key}: flax {arr.shape} vs port {tuple(target[key])}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters not filled from the flax tree: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''} ({len(missing)} total)")
    return out


def vae_decode_tree(vae_tree: Mapping) -> Dict:
    """The decode half of a full AutoencoderKL tree (decoder + post_quant_conv)."""
    t = _unwrap(vae_tree)
    return {k: t[k] for k in VAE_DECODE_KEYS}


def load_flax_(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax tree into `module`'s parameters in place (on its device)."""
    sd = state_dict_from_flax(tree, module)
    module.load_state_dict(sd, strict=True)
    return module


def merge_variables(variables: Mapping) -> Dict:
    """flax `{"params": P, "batch_stats": S}` → one tree holding both (their
    leaf names differ: scale/bias/kernel against mean/var)."""
    def merge(a: Mapping, b: Mapping) -> Dict:
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(v, Mapping) and isinstance(out[k], Mapping):
                out[k] = merge(out[k], v)
            elif k in out:
                raise KeyError(f"batch_stats leaf {k!r} collides with a parameter")
            else:
                out[k] = v
        return out

    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected flax collections {sorted(extra)}")
    return merge(variables.get("params", {}), variables.get("batch_stats", {}))


def load_variables_(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax variables (params and batch_stats) into `module` in place,
    strict both ways."""
    return load_flax_(module, merge_variables(variables))


def to_flax_variables(module: nn.Module) -> Dict[str, Dict]:
    """`module` → `{"params": ..., "batch_stats": ...}` in flax's layout, as
    numpy float32 (Linear → Dense kernel (in, out), Conv2d → HWIO kernel,
    BatchNorm → scale/bias and mean/var); raises on a module of any other
    kind that holds tensors of its own."""
    from ..models.batchnorm import BatchNorm

    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}

    def put(collection: str, name: str, leaf: str, t: torch.Tensor, perm=None):
        node = out[collection]
        for part in name.split("."):
            node = node.setdefault(part, {})
        arr = t.detach().float().cpu().numpy()
        node[leaf] = np.ascontiguousarray(arr if perm is None else arr.transpose(perm))

    for name, m in module.named_modules():
        own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        if not own:
            continue
        if isinstance(m, nn.Linear):
            put("params", name, "kernel", m.weight, (1, 0))
        elif isinstance(m, nn.Conv2d):
            put("params", name, "kernel", m.weight, (2, 3, 1, 0))
        elif isinstance(m, BatchNorm):
            put("params", name, "scale", m.weight)
            put("batch_stats", name, "mean", m.mean)
            put("batch_stats", name, "var", m.var)
        else:
            raise TypeError(f"to_flax_variables: no flax layout for {type(m).__name__} at {name!r}")
        if getattr(m, "bias", None) is not None:
            put("params", name, "bias", m.bias)
    return out


def to_flax_tree(tensors: Mapping[str, torch.Tensor], like: Mapping) -> Dict:
    """Port tensors by state_dict name (a state_dict, named_parameters, an
    EMA) → numpy leaves in the structure and layout of the flax tree `like`."""
    def walk(tree: Mapping, prefix: Tuple[str, ...]) -> Dict:
        out = {}
        for k, v in tree.items():
            path = prefix + (str(k),)
            if isinstance(v, Mapping):
                out[k] = walk(v, path)
                continue
            key, perm = torch_key(path, np.ndim(v))
            arr = tensors[key].detach().float().cpu().numpy()
            out[k] = np.array(arr if perm is None else arr.transpose(np.argsort(perm)))
        return out

    return walk(_unwrap(like), ())

