"""Reader and writer of psd_tpu's flat npz parameter files.

`psd_tpu/convert/io.py` writes a flax parameter tree to one npz, its keys
the tree paths joined by "::" (`save_params_npz`): the frozen VAE and CLIP
weights that `--vae-params`, `--clip-params` and a checkpoint's
`frozen/{vae,clip}.npz` name. `load_params_npz` gives the nested dict of
numpy arrays that `convert/from_jax.py` bridges; `save_params_npz` writes
one in that format (the classifier's checkpoints, `pipelines/classify.py`),
so psd_tpu reads it with its own `load_params_npz`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

SEP = "::"


def load_params_npz(path: str | Path) -> Dict:
    """npz → the nested dict of numpy arrays it was written from."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split(SEP)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params_npz(tree: Dict, path: str | Path) -> None:
    """The nested dict of arrays → one npz, its keys the paths joined by "::"."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(tree))
