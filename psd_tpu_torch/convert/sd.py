"""diffusers SD-v1.x state_dict → psd_tpu's parameter trees (UNet + VAE).

The port's copy of `psd_tpu/convert/sd.py`: the same name map, the same
layout rules and the same leaves, so a checkpoint converted here writes the
npz that `scripts/port_weights.py` writes on a machine with JAX (the tests
hold the two copies bit-equal). It turns a flat {diffusers key: array} dict
(`load_torch_state_dict` reads one from a file) into {"params": tree} in
flax's layout, which `convert/npz.py` saves and `convert/from_jax.py`
bridges into the port's modules.

Layout rules:
  torch Linear (out,in)        → flax kernel (in,out)       = W.T
  torch Conv2d (out,in,kh,kw)  → flax NHWC kernel (kh,kw,in,out)
  torch *Norm weight/bias      → flax scale/bias

Split-injection extras: `to_k_dis`/`to_v_dis` are warm-started from the
pretrained text-cross-attention K/V.

The reader takes `.safetensors` without the `safetensors` package (the
format is a little-endian u64 header length, a JSON header of
{name: {dtype, shape, data_offsets}} and `__metadata__`, then the raw
bytes) and torch `.bin`/`.pt` files through `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict

import numpy as np
import torch


def _lin(w):
    return np.asarray(w, np.float32).T


def _conv(w):
    return np.asarray(w, np.float32).transpose(2, 3, 1, 0)


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# the tensor dtypes the .safetensors reader takes, as numpy reads their
# bytes (numpy has no bf16: those go through torch); the floating ones are
# widened to float32, the others kept as they are
SAFETENSORS_DTYPES = {"F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
                      "BF16": np.dtype("<u2"), "BOOL": np.dtype("?"), "U8": np.dtype("u1"),
                      "I8": np.dtype("i1"), "I16": np.dtype("<i2"), "U16": np.dtype("<u2"),
                      "I32": np.dtype("<i4"), "U32": np.dtype("<u4"), "I64": np.dtype("<i8"),
                      "U64": np.dtype("<u8")}
FLOATING = ("F64", "F32", "F16", "BF16")


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """A .safetensors file → {name: array}, in the order of the tensors'
    bytes in the file (`safetensors.numpy.load_file`'s). The file is mapped,
    not read: F32 tensors are views of the mapping; F64, F16 and BF16 become
    float32 (as a `.bin`'s floating tensors do); BOOL and the integer dtypes
    keep their own numpy dtype, as `load_file` gives them. A dtype numpy
    cannot hold (F8_*, an unknown name), or a header that does not describe
    the file, raises."""
    path = Path(path)
    mapped = np.memmap(path, dtype=np.uint8, mode="c")  # copy-on-write: torch.frombuffer needs it writable
    if mapped.size < 8:
        raise ValueError(f"{path}: {mapped.size} bytes, too short for a .safetensors header")
    n = int(mapped[:8].view("<u8")[0])
    if 8 + n > mapped.size:
        raise ValueError(f"{path}: a header of {n} bytes in a file of {mapped.size}")
    header = json.loads(bytes(mapped[8:8 + n]))
    header.pop("__metadata__", None)
    data = mapped[8 + n:]
    out = {}
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} is {dtype}; the reader takes "
                             f"{', '.join(SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * SAFETENSORS_DTYPES[dtype].itemsize or not 0 <= begin <= end <= data.size:
            raise ValueError(f"{path}: tensor {name!r} ({dtype}, {shape}) has bytes "
                             f"[{begin}, {end}) of {data.size}")
        raw = data[begin:end]
        kept = np.float32 if dtype in FLOATING else SAFETENSORS_DTYPES[dtype]
        if count == 0:
            arr = np.zeros(shape, kept)
        elif dtype == "BF16":
            arr = torch.frombuffer(raw, dtype=torch.bfloat16).float().numpy().reshape(shape)
        else:
            arr = raw.view(SAFETENSORS_DTYPES[dtype]).astype(kept, copy=False).reshape(shape)
        out[name] = arr
    return out


def load_torch_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a .safetensors or torch .bin/.pt file into numpy arrays (a .bin's
    floating tensors as float32, its others, such as BatchNorm's
    `num_batches_tracked`, as they are)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in sd.items()}


def _convert_generic(sd: Dict[str, np.ndarray], name_map) -> Dict:
    """Walk torch keys; name_map(torch_key) → flax path tuple or None. A 1-D
    weight is a norm's scale; its bias lands beside it."""
    params: Dict = {}
    for key, val in sd.items():
        if not (key.endswith(".weight") or key.endswith(".bias")):
            continue
        is_bias = key.endswith(".bias")
        base = key[: -len(".bias")] if is_bias else key[: -len(".weight")]
        path = name_map(base)
        if path is None:
            continue
        if is_bias:
            _set(params, path + ("bias",), np.asarray(val, np.float32))
        elif val.ndim == 4:
            _set(params, path + ("kernel",), _conv(val))
        elif val.ndim == 2:
            _set(params, path + ("kernel",), _lin(val))
        else:
            _set(params, path + ("scale",), np.asarray(val, np.float32))
    return params


_BLOCK_RE = re.compile(
    r"^(down_blocks|up_blocks)\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)\.(\d+)\.(.*)$"
)
_MID_RE = re.compile(r"^mid_block\.(resnets|attentions)\.(\d+)\.(.*)$")


def _map_inner(rest: str):
    """Map the within-block remainder of a diffusers key to flax path parts."""
    rest = rest.replace("to_out.0", "to_out_0")
    rest = rest.replace("ff.net.0.proj", "ff.net_0_proj")
    rest = rest.replace("ff.net.2", "ff.net_2")
    m = re.match(r"^transformer_blocks\.(\d+)\.(.*)$", rest)
    if m:
        return (f"transformer_blocks_{m.group(1)}",) + tuple(m.group(2).split("."))
    return tuple(rest.split("."))


def unet_name_map(base: str):
    """diffusers UNet2DConditionModel key → the UNet2DCondition path."""
    if base.startswith("conv_in"):
        return ("conv_in",)
    if base.startswith("conv_out"):
        return ("conv_out",)
    if base.startswith("conv_norm_out"):
        return ("conv_norm_out",)
    m = re.match(r"^time_embedding\.(linear_[12])$", base)
    if m:
        return ("time_embedding", m.group(1))
    m = _BLOCK_RE.match(base)
    if m:
        where, i, kind, j, rest = m.groups()
        block = f"{where}_{i}_{kind}_{j}"
        if kind in ("downsamplers", "upsamplers"):
            return (block, "conv") if rest == "conv" else None
        return (block,) + _map_inner(rest)
    m = _MID_RE.match(base)
    if m:
        kind, j, rest = m.groups()
        return (f"mid_block_{kind}_{j}",) + _map_inner(rest)
    return None


def convert_sd_unet(
    sd: Dict[str, np.ndarray], warm_start_kv_dis: bool = True
) -> Dict:
    """Returns {"params": tree}; optionally adds to_k_dis/to_v_dis copies."""
    params = _convert_generic(sd, unet_name_map)
    if warm_start_kv_dis:
        for key in list(sd.keys()):
            m = re.match(
                r"^(.*transformer_blocks\.\d+\.attn2)\.to_([kv])\.weight$", key
            )
            if not m:
                continue
            base, kv = m.groups()
            path = unet_name_map(base + f".to_{kv}")
            if path is None:
                continue
            dis_path = path[:-1] + (f"to_{kv}_dis",)
            _set(params, dis_path + ("kernel",), _lin(sd[key]))
    return {"params": params}


def vae_name_map_factory(side: str):
    """side ∈ {encoder, decoder} inner key → path under that submodule."""

    def _map(base: str):
        if not base.startswith(side + "."):
            return None
        rest = base[len(side) + 1 :]
        if rest.startswith("conv_in"):
            return (side, "conv_in")
        if rest.startswith("conv_norm_out"):
            return (side, "conv_norm_out")
        if rest.startswith("conv_out"):
            return (side, "conv_out")
        m = _BLOCK_RE.match(rest)
        if m:
            where, i, kind, j, inner = m.groups()
            block = f"{where}_{i}_{kind}_{j}"
            if kind == "downsamplers":
                # VAE encoder downsampling is a bare conv (asymmetric pad)
                return (side, block) if inner == "conv" else None
            if kind == "upsamplers":
                return (side, block, "conv") if inner == "conv" else None
            return (side, block) + tuple(inner.split("."))
        m = _MID_RE.match(rest)
        if m:
            kind, j, inner = m.groups()
            if kind == "attentions":
                inner = inner.replace("to_out.0", "to_out_0")
                # legacy diffusers VAE attention names
                legacy = {"q": "to_q", "k": "to_k", "v": "to_v",
                          "proj_attn": "to_out_0", "norm": "group_norm"}
                parts = inner.split(".")
                parts[0] = legacy.get(parts[0], parts[0])
                return (side, "mid_block", f"attentions_{j}") + tuple(parts)
            return (side, "mid_block", f"resnets_{j}") + tuple(inner.split("."))
        return None

    return _map


def convert_sd_vae(sd: Dict[str, np.ndarray]) -> Dict:
    params: Dict = {}
    for side in ("encoder", "decoder"):
        sub = _convert_generic(sd, vae_name_map_factory(side))
        params.update(sub)
    for extra in ("quant_conv", "post_quant_conv"):
        w, b = sd.get(extra + ".weight"), sd.get(extra + ".bias")
        if w is not None:
            _set(params, (extra, "kernel"), _conv(w))
            _set(params, (extra, "bias"), np.asarray(b, np.float32))
    # VAE attention linear weights may ship as (C,C,1,1) convs in old
    # checkpoints → squeeze to linear kernels
    def _fix(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                _fix(v)
            elif k == "kernel" and v.ndim == 4 and v.shape[0] == v.shape[1] == 1:
                node[k] = v[0, 0]
    for side in ("encoder", "decoder"):
        att = params.get(side, {}).get("mid_block", {}).get("attentions_0")
        if att:
            _fix(att)
    return {"params": params}
