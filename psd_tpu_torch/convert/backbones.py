"""torchvision backbone state_dict → psd_tpu's variables trees.

The port's copy of `psd_tpu/convert/backbones.py` (the tests hold the two
bit-equal): ImageNet ResNet-18/34/50/101 (the classifier's backbones), VGG16
(the IPR features) and torchvision's InceptionV3 (the FID features), as
{"params", "batch_stats"} trees that `convert/from_jax.py::load_variables_`
loads into `models/{resnet,vgg,inception}.py`. Same layout rules as
`convert/sd.py`.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .sd import _conv, _lin, _set


def _bn(sd: Dict, base: str) -> Dict:
    return {
        "scale": np.asarray(sd[base + ".weight"], np.float32),
        "bias": np.asarray(sd[base + ".bias"], np.float32),
    }


def _bn_stats(sd: Dict, base: str) -> Dict:
    return {
        "mean": np.asarray(sd[base + ".running_mean"], np.float32),
        "var": np.asarray(sd[base + ".running_var"], np.float32),
    }


def convert_resnet(sd: Dict[str, np.ndarray], keep_fc: bool = False) -> Dict:
    """torchvision resnet{18,34,50,101} → {"params", "batch_stats"}."""
    params: Dict = {}
    stats: Dict = {}

    params["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    params["bn1"] = _bn(sd, "bn1")
    stats["bn1"] = _bn_stats(sd, "bn1")

    block_re = re.compile(r"^layer(\d)\.(\d+)\.(.*?)\.(weight|bias|running_mean|running_var)$")
    seen = set()
    for key in sd:
        m = block_re.match(key)
        if not m:
            continue
        li, bi, inner, _ = m.groups()
        seen.add((li, bi, inner))
    for li, bi, inner in sorted(seen):
        block = f"layer{li}_{bi}"
        base = f"layer{li}.{bi}.{inner}"
        if inner.startswith("conv"):
            _set(params, (block, inner, "kernel"), _conv(sd[base + ".weight"]))
        elif inner.startswith("bn"):
            _set(params, (block, inner), _bn(sd, base))
            _set(stats, (block, inner), _bn_stats(sd, base))
        elif inner == "downsample.0":
            _set(params, (block, "downsample_conv", "kernel"),
                 _conv(sd[base + ".weight"]))
        elif inner == "downsample.1":
            _set(params, (block, "downsample_bn"), _bn(sd, base))
            _set(stats, (block, "downsample_bn"), _bn_stats(sd, base))
    if keep_fc and "fc.weight" in sd:
        params["fc"] = {"kernel": _lin(sd["fc.weight"]),
                        "bias": np.asarray(sd["fc.bias"], np.float32)}
    return {"params": params, "batch_stats": stats}


def convert_vgg16(sd: Dict[str, np.ndarray]) -> Dict:
    """torchvision vgg16 → VGG16Features params (fc7-truncated).

    torchvision features indices with convs at 0,2,5,7,10,12,14,17,19,21,
    24,26,28; classifier Linear at 0 (fc6) and 3 (fc7).
    """
    conv_indices = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    params: Dict = {}
    for our_i, tv_i in enumerate(conv_indices):
        params[f"conv_{our_i}"] = {
            "kernel": _conv(sd[f"features.{tv_i}.weight"]),
            "bias": np.asarray(sd[f"features.{tv_i}.bias"], np.float32),
        }
    params["fc6"] = {"kernel": _lin(sd["classifier.0.weight"]),
                     "bias": np.asarray(sd["classifier.0.bias"], np.float32)}
    params["fc7"] = {"kernel": _lin(sd["classifier.3.weight"]),
                     "bias": np.asarray(sd["classifier.3.bias"], np.float32)}
    return {"params": params}


def convert_inception_v3(sd: Dict[str, np.ndarray]) -> Dict:
    """torchvision inception_v3 → InceptionV3Features {"params","batch_stats"}.

    Every BasicConv2d is `<block>.conv.weight` + `<block>.bn.*`; block names
    match ours 1:1 (Conv2d_1a_3x3, Mixed_5b.branch1x1, ...). AuxLogits/fc
    are dropped.
    """
    params: Dict = {}
    stats: Dict = {}
    for key in sd:
        if key.startswith("AuxLogits") or key.startswith("fc."):
            continue
        m = re.match(r"^(.*)\.conv\.weight$", key)
        if m:
            path = tuple(m.group(1).split("."))
            _set(params, path + ("conv", "kernel"), _conv(sd[key]))
            continue
        m = re.match(r"^(.*)\.bn\.(weight|bias|running_mean|running_var)$", key)
        if m:
            base, kind = m.groups()
            path = tuple(base.split(".")) + ("bn",)
            val = np.asarray(sd[key], np.float32)
            if kind == "weight":
                _set(params, path + ("scale",), val)
            elif kind == "bias":
                _set(params, path + ("bias",), val)
            elif kind == "running_mean":
                _set(stats, path + ("mean",), val)
            else:
                _set(stats, path + ("var",), val)
    return {"params": params, "batch_stats": stats}
